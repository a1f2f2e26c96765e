"""repro_torch.launch — the launchers: ``serve`` (batched generation with
the continuous-batching engine).  Training, mesh and dry-run launchers come
with the training slice of the port."""
