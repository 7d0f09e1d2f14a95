"""Serving launcher: batched-request generation with the rollout engine
(the inference-cluster side of AsyncFlow, standalone).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_7b \
      --requests 8 --max-new-tokens 16 --engine continuous

``--engine continuous`` serves through the same
``engines/continuous_batching`` subsystem the RL rollout stage uses
(slot scheduler + paged KV cache); ``fixed`` keeps the padded-batch decode
loop. Both run on ``cuda`` unless ``--device cpu`` is given. As in the
reference, the model is the arch's reduced variant with the byte
tokenizer's vocab and random weights from ``--seed``.

``--replicas N`` serves through a supervised generator fleet: N replica
threads, each with its own continuous-batching engine over one shared
parameter tree, behind a :class:`ReplicaSupervisor` service registry.
With ``--crash-p`` > 0 a deterministic :class:`FaultInjector` kills
replicas mid-serve; crashed replicas requeue their in-flight request to
the front of the work queue and are respawned, so every request completes
exactly once:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --engine continuous --replicas 3 --crash-p 0.1 --fault-seed 7
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import json
import sys
import threading
import time


def _serve_fleet(args, cfg, params, prompts, tok, device=None):
    """Supervised replica fleet: a shared work queue drained by
    ``args.replicas`` replica threads; crashes requeue the in-flight
    request and respawn. ``prompts`` are {"tokens", "text"} dicts. Returns
    (outputs in prompt order, each {"prompt", "response",
    "response_ids"}; the restarts)."""
    from repro_torch.core.supervision import (FaultConfig, FaultInjector,
                                              ReplicaCrash, ReplicaSupervisor)
    from repro_torch.engines.continuous_batching import \
        ContinuousBatchingEngine

    work = collections.deque(enumerate(prompts))
    wlock = threading.Lock()
    outputs: dict = {}
    stop = threading.Event()
    inj = FaultInjector(FaultConfig(crash_p=args.crash_p,
                                    seed=args.fault_seed,
                                    stages=("serve",)))
    max_len = max(len(p["tokens"]) for p in prompts) + args.max_new_tokens
    sup = ReplicaSupervisor(lambda dead: _spawn(),
                            heartbeat_timeout_s=60.0,
                            max_restarts=0, stage="serve")
    rid_seq = itertools.count()
    errors = []

    def _replica(handle):
        eng = ContinuousBatchingEngine(
            cfg, num_slots=args.slots, max_len=max_len,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, seed=args.seed, device=device)
        while not stop.is_set():
            handle.beat()
            with wlock:
                if not work:
                    sup.retire(handle.rid)
                    return
                item = work.popleft()
            try:
                inj.check("serve", handle.rid)
                i, p = item
                q = eng.make_sequence(p["tokens"], meta={"prompt": p})
                done, _ = eng.generate(params, [q])
                ids = [int(t) for t in done[0].tokens[done[0].prompt_len:]]
                with wlock:
                    if i in outputs:
                        raise RuntimeError(f"request {i} answered twice")
                    outputs[i] = {"prompt": p["text"],
                                  "response": tok.decode(ids),
                                  "response_ids": ids}
            except ReplicaCrash as e:
                with wlock:
                    work.appendleft(item)    # in-flight request requeues
                sup.report_death(handle.rid, repr(e))
                return
            except Exception as e:         # a real fault ends the serve:
                errors.append(e)           # the caller raises it
                stop.set()
                return
        sup.retire(handle.rid)

    def _spawn() -> bool:
        rid = next(rid_seq)
        h = sup.register(rid, None, stage="serve")
        t = threading.Thread(target=_replica, args=(h,), daemon=True)
        h.thread = t
        t.start()
        return True

    for _ in range(args.replicas):
        _spawn()
    while len(outputs) < len(prompts) and not errors:
        sup.poll()
        time.sleep(0.01)
    stop.set()
    for h in sup.replicas(None):
        if h.thread is not None:
            h.thread.join()
    if errors:
        raise errors[0]
    return [outputs[i] for i in range(len(prompts))], sup.restarts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=("fixed", "continuous"),
                    default="fixed")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (continuous engine)")
    ap.add_argument("--replicas", type=int, default=1,
                    help=">1: supervised generator fleet (continuous)")
    ap.add_argument("--crash-p", type=float, default=0.0,
                    help="deterministic crash probability per request")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data import PromptDataset
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.rl.sampling import require_token_model

    device = resolve_device(args.device)
    tok = ByteTokenizer()
    cfg = dataclasses.replace(get_config(args.arch).reduced(),
                              vocab_size=tok.vocab_size)
    require_token_model(cfg, "launch.serve")
    params = init_params(args.seed, cfg, device=device)
    ds = PromptDataset(seed=args.seed)
    prompts = ds.prompts_for_step(0, args.requests)

    t0 = time.time()
    n_tokens = 0
    outputs = []
    restarts = 0
    if args.replicas > 1:
        outputs, restarts = _serve_fleet(args, cfg, params, prompts, tok,
                                         device)
        n_tokens = sum(len(o.pop("response_ids")) for o in outputs)
    elif args.engine == "continuous":
        from repro_torch.engines.continuous_batching import \
            ContinuousBatchingEngine
        max_len = max(len(p["tokens"]) for p in prompts) \
            + args.max_new_tokens
        eng = ContinuousBatchingEngine(
            cfg, num_slots=args.slots, max_len=max_len,
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, seed=args.seed, device=device)
        seqs = [eng.make_sequence(p["tokens"], meta={"prompt": p})
                for p in prompts]
        done, _ = eng.generate(params, seqs)
        done.sort(key=lambda q: q.uid)
        for q in done:
            ids = q.tokens[q.prompt_len:]
            outputs.append({"prompt": q.meta["prompt"]["text"],
                            "response": tok.decode(ids)})
            n_tokens += len(ids)
    else:
        from repro_torch.rl.sampling import generate
        for i in range(0, len(prompts), args.batch_size):
            chunk = prompts[i:i + args.batch_size]
            rows = generate(params, cfg, [p["tokens"] for p in chunk],
                            args.seed + i,
                            max_new_tokens=args.max_new_tokens,
                            temperature=args.temperature, device=device)
            for p, r in zip(chunk, rows):
                outputs.append({"prompt": p["text"],
                                "response": tok.decode(r["response_ids"])})
                n_tokens += len(r["response_ids"])
    wall = time.time() - t0
    print(json.dumps({"arch": args.arch, "engine": args.engine,
                      "device": str(device),
                      "requests": len(prompts),
                      "replicas": args.replicas,
                      "replica_restarts": restarts,
                      "wall_s": round(wall, 2),
                      "tokens_per_s": round(n_tokens / wall, 1),
                      "samples": outputs[:4]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
