"""repro_torch.scripts — the port's counterparts of ``scripts/``, each run as
``python -m repro_torch.scripts.<name>``: ``plan_diff`` (the structural
diff of two plan artifacts, K splits and cluster sizes included)."""
