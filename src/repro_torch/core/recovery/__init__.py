"""Recovery & durability: atomic versioned run snapshots (engine state +
streaming cursors + TransferQueue watermarks) with LATEST pointer,
keep-last-k retention and torn-snapshot fallback — the substrate for
warm trainer restarts and cold ``Trainer.fit(resume=...)``."""
from repro_torch.core.recovery.snapshot import RunCheckpointer

__all__ = ["RunCheckpointer"]
