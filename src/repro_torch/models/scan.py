"""The log-depth linear recurrence h_t = a_t h_{t-1} + b_t, shared by the
training routes of the ssm (``models/ssm.py``) and hybrid
(``models/rglru.py``) families."""
import torch


def associative_scan(a, b):
    """Inclusive scan over axis 1 of the pairs (a, b) under
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, b_r + a_r b_l), as a log-depth
    (Hillis-Steele) scan: differentiable and out of place, the reference's
    ``jax.lax.associative_scan`` in another order of the same products.
    Returns (the products a_1 ... a_t, h_t from a zero state); with a
    carry h_0, h_t is ``h + prod * h_0``."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b
