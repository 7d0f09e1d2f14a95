"""SM-idle ms a decode round of the traced GRPO step (the rollout
workers' continuous engine at 32 slots) while the round's thread is in
its host phases (``cb.round`` children ``prepare``, ``forward``,
``sample`` and ``retire``), over the rounds wholly inside the step."""
from perfbench.core.program_spans import HOST_PHASES, round_idle_ms


def read(ctx):
    return round_idle_ms(ctx, HOST_PHASES)
