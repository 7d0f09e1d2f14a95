"""AsyncFlow core — the paper's contributions:

  transfer_queue/  C1: streaming dataloader (control plane + data plane)
  workflow/        C2: producer-consumer async workflow, delayed param update
  planner/         C4: hybrid cost model + simulator + resource planner
(C3, the service-oriented interface, lives in repro_torch.api /
repro_torch.engines.) Beside them: obs/ (telemetry), supervision/ (the
generator fleet) and recovery/ (durable run snapshots).
"""
