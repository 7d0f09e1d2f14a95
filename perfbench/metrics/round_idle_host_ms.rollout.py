"""SM-idle ms a decode round of the traced serving stretch while the
round's thread is in its host phases (the program's ``cb.round`` children
``prepare``, ``forward``, ``sample`` and ``retire``; the SMs are idle
when no kernel runs), over the rounds wholly inside the stretch."""
from perfbench.core.program_spans import HOST_PHASES, round_idle_ms


def read(ctx):
    return round_idle_ms(ctx, HOST_PHASES)
