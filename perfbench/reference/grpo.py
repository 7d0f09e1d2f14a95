"""The reference's GRPO: rewards and group advantages, the clipped
surrogate with the k3 KL to a frozen reference, gradient accumulation
over micro-batches and AdamW, followed through a run's first steps.

It trains on the samples the program generated (the reference reads them
to judge their logprobs, and cannot draw the same samples itself), in the
micro-batches the program's step driver formed them into; everything else
(rewards, advantages, behaviour and reference logprobs, losses, gradients,
updates) it works out again from the benchmark's weights and prompts.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.core import traffic as traffic_mod
from perfbench.core.weights import leaf, make, nest, tree_items
from perfbench.reference import lm


def pad_rows(rows: List[dict], device):
    """(tokens (n, S) long, mask (n, S) float32), right-padded with 0."""
    S = max(len(r["tokens"]) for r in rows)
    toks = np.zeros((len(rows), S), np.int64)
    mask = np.zeros((len(rows), S), np.float32)
    for i, r in enumerate(rows):
        toks[i, :len(r["tokens"])] = r["tokens"]
        mask[i, :len(r["mask"])] = r["mask"]
    return (torch.from_numpy(toks).to(device),
            torch.from_numpy(mask).to(device))


def _targets_lp(logits, toks):
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return lp.gather(2, toks[:, 1:, None])[..., 0]


@torch.no_grad()
def row_logprobs(params, c, prec, rows, device, batch=8):
    """Per row, float32 logprobs of tokens[1:] (index j is token j + 1)."""
    out = []
    for k in range(0, len(rows), batch):
        part = rows[k:k + batch]
        toks, _ = pad_rows(part, device)
        lp = _targets_lp(lm.forward(params, toks, c, prec), toks).cpu()
        out += [lp[i, :len(r["tokens"]) - 1].numpy()
                for i, r in enumerate(part)]
    return out


def loss_fn(params, c, prec, rows, old, ref, adv, rl, device):
    toks, mask = pad_rows(rows, device)
    S = toks.shape[1]

    def col(vals):
        a = np.zeros((len(rows), S - 1), np.float32)
        for i, v in enumerate(vals):
            a[i, :len(v)] = v
        return torch.from_numpy(a).to(device)

    old_t, ref_t = col(old), col(ref)
    adv_t = torch.as_tensor(np.asarray(adv, np.float32), device=device)
    lp = _targets_lp(lm.forward(params, toks, c, prec), toks)
    m = mask[:, 1:]
    ratio = torch.exp(lp - old_t)
    a = adv_t[:, None]
    eps = rl["clip_eps"]
    pl = -torch.minimum(ratio * a, torch.clamp(ratio, 1 - eps, 1 + eps) * a)
    d = ref_t - lp
    kl = torch.exp(d) - d - 1.0
    denom = torch.clamp(m.sum(), min=1.0)
    return (pl * m).sum() / denom + rl["kl_coef"] * (kl * m).sum() / denom


def advantages(rows: List[dict], all_rows: List[dict],
               prompts: Dict[bytes, dict], rule: dict,
               group_size: int) -> Dict[int, float]:
    """{uid: group advantage} of ``rows``, from the rewards of every row
    recorded for the same prompt (a group's members may train in
    different steps)."""
    key = lambda r: r["tokens"][:r["prompt_len"]].tobytes()
    need = {key(r) for r in rows}
    groups: Dict[bytes, list] = {}
    for r in all_rows:
        k = key(r)
        if k in need:
            ids = r["tokens"][np.asarray(r["mask"]) > 0]
            groups.setdefault(k, []).append(
                (r["uid"], traffic_mod.reward(rule, prompts[k]["answer"],
                                              ids)))
    adv = {}
    for members in groups.values():
        if len(members) != group_size:
            raise ValueError(f"a group holds {len(members)} recorded "
                             f"samples, not {group_size}")
        a = traffic_mod.group_advantages([m[1] for m in members])
        adv.update((uid, float(x)) for (uid, _), x in zip(members, a))
    return adv


def adamw(params, grads, state, opt: dict):
    """One AdamW step (global-norm clipping, decoupled weight decay, a
    constant rate after a linear warm-up) in float32. Returns (the
    clipped gradients' per-leaf norms, the new params); ``state`` is
    updated in place."""
    norms = [torch.linalg.vector_norm(g) for _, g in tree_items(grads)]
    gnorm = torch.linalg.vector_norm(torch.stack(norms))
    scale = torch.clamp(opt["grad_clip"] / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = opt["lr"] * min(1.0, (state["count"] + 1) / max(
        opt["warmup_steps"], 1))
    state["count"] += 1
    n = state["count"]
    b1, b2 = opt["betas"]
    clipped = {}
    new = {}
    for (path, p), (_, g) in zip(tree_items(params), tree_items(grads)):
        g = g * scale
        clipped[path] = float(torch.linalg.vector_norm(g))
        m = state["m"].setdefault(path, torch.zeros_like(p))
        v = state["v"].setdefault(path, torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        step = (m / (1 - b1 ** n)) / ((v / (1 - b2 ** n)).sqrt() + opt["eps"])
        new[path] = p - lr * (step + opt["weight_decay"] * p)
    return clipped, new


def follow(c, prec, seed: int, steps: List[List[List[dict]]],
           all_rows: List[dict], prompts: Dict[bytes, dict], mix: dict,
           device, drop_half: bool = False) -> dict:
    """The reference through the recorded steps. ``steps[s]`` holds step
    s's micro-batches of rows; ``all_rows`` every row the program trained
    on in the run (for the groups' rewards). Returns the readings the
    comparison takes: each row's behaviour and reference logprobs over
    its response, each step's loss, the first step's clipped gradient's
    norm per leaf, and each leaf's change from the initial weights after
    each step (``change_norm[v]`` for the weights of version v = 1, 2,
    ...). ``drop_half`` plants a fault for the limits' readings: each
    micro-batch's loss leaves out the second half of its rows."""
    rl = mix["trainer"]
    opt = dict(mix["optimizer"], lr=rl["lr"])
    G = mix["group_size"]
    params = make(lm.layout(c), seed, device)
    flat_rows = [r for st in steps for mb in st for r in mb]
    adv_of = advantages(flat_rows, all_rows, prompts, mix["reward"], G)
    ref_lp = row_logprobs(params, c, prec, flat_rows, device)
    ref_of = {r["uid"]: lp for r, lp in zip(flat_rows, ref_lp)}
    old_of = {r["uid"]: ref_of[r["uid"]] for r in flat_rows
              if r["version"] == 0}
    state = {"m": {}, "v": {}, "count": 0}
    losses, first_grad, change = [], None, {}
    for s, micro in enumerate(steps):
        if s:
            todo = [r for r in flat_rows if r["version"] == s]
            for r, lp in zip(todo, row_logprobs(params, c, prec, todo,
                                                device)):
                old_of[r["uid"]] = lp
        acc, step_losses = None, []
        for mb in micro:
            if drop_half:
                mb = mb[:max(1, len(mb) // 2)]
            live = {path: t.detach().requires_grad_()
                    for path, t in tree_items(params)}
            tree = nest(live.items())
            with torch.enable_grad():
                loss = loss_fn(tree, c, prec, mb,
                               [old_of[r["uid"]] for r in mb],
                               [ref_of[r["uid"]] for r in mb],
                               [adv_of[r["uid"]] for r in mb], rl, device)
                grads = torch.autograd.grad(loss, list(live.values()))
            step_losses.append(float(loss.detach()))
            if acc is None:
                acc = dict(zip(live, grads))
            else:
                for path, g in zip(live, grads):
                    acc[path].add_(g)
            del grads, live, tree
        for g in acc.values():
            g.div_(float(len(micro)))
        gtree = nest(acc.items())
        clipped, new = adamw(params, gtree, state, opt)
        del acc, gtree
        if s == 0:
            first_grad = clipped
        params = nest(new.items())
        losses.append(float(np.mean(step_losses)))
        change[s + 1] = _change(params, c, seed, device)
    return {"rollout_lp": {u: v for u, v in old_of.items()},
            "ref_lp": ref_of, "loss": losses, "grad_norm": first_grad,
            "change_norm": change}


def _change(params, c, seed, device) -> dict:
    """Each leaf's norm of change from the initial weights."""
    out = {}
    for (path, shape, init) in lm.layout(c):
        p0 = leaf(path, shape, init, seed, device)
        out[path] = float(torch.linalg.vector_norm(
            p0.sub_(_get(params, path))))
        del p0
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree
