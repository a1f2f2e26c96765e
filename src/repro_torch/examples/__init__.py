"""repro_torch.examples — the user walkthroughs of ``examples/`` on the port.

Each module mirrors the file of the same name in ``examples/`` and runs as
``python -m repro_torch.examples.<name>``: on the CUDA card by default, on
the CPU with ``--device cpu`` (each kernel wrapper then runs its plain
version), and it raises when no card is present and no device is named.
Its ``main(argv=None)`` returns a dict of what it checked — equalities,
counts, rates and the hand-written kernels' launches — and prints that
dict as one JSON line last.
"""
import argparse
import json
from typing import Any, Dict

import numpy as np


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.generic):  # numpy scalars in server summaries
        return v.item()
    raise TypeError(f"not JSON-serializable: {type(v).__name__}")


def finish(result: Dict[str, Any]) -> Dict[str, Any]:
    """Print ``result`` as the example's last line (one JSON object) and
    return it."""
    print(json.dumps(result, default=_jsonable, sort_keys=True), flush=True)
    return result
