"""SM-idle ms a decode round of the traced GRPO step while the round's
thread waits for the device in ``sync`` (the ``.tolist()`` of the
sampled tokens), over the rounds wholly inside the step."""
from perfbench.core.program_spans import SYNC_PHASES, round_idle_ms


def read(ctx):
    return round_idle_ms(ctx, SYNC_PHASES)
