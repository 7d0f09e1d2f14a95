"""Streaming stage-graph: composable multi-task RL dataflows (paper §3.3, §4.1).

The paper's central architectural claim is that per-task TransferQueue
controllers over a shared data plane let *arbitrary* RL dataflows
(rollout, ref_inference, reward, critic/actor update, ...) stream and
overlap automatically. This module is that claim as a subsystem:

* :class:`StageSpec` — one named RL task: the columns it consumes, the
  columns it writes, and the engine verb (``RLAdapter``) that does the
  work.
* :class:`StageGraph` — a validated DAG of stages over a single shared
  column namespace. Topology checks (missing producers, duplicate
  producers, cycles) run before anything is scheduled.
* :class:`StageRunner` — compiles a graph onto ONE shared
  :class:`TransferQueue` (one controller per stage, §3.3) and spawns
  producer/consumer worker threads per stage. Rows flow column-by-column:
  a stage's controller schedules a row the instant its required columns
  are all present, so every intermediate task streams as its own pipeline
  stage — no global-batch barriers anywhere between source and sink.

Stage verbs return a plain dict with any of:

* ``rows``     — new sample rows to append (dict column -> value); used by
  the generate stage to fan a prompt out into G experience rows.
* ``requeue``  — continuation items fed back into the source column
  (partial rollout, §4.2.1).
* ``updates``  — {column: [values]} written back onto the consumed rows.
* ``writes``   — [(row_idx, column, value)] cross-row writes (e.g. GRPO
  group advantages that complete on a later micro-batch).

Workflow modes (baseline / streaming / async), the staleness gate,
delayed parameter update and the per-mode prompt release schedule are
owned by the runner, so every dataflow — built-in or user-registered via
:func:`register_dataflow` — inherits the paper's §4.2 machinery.
"""
from __future__ import annotations

import inspect
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.obs import (MetricsRegistry, MetricsSampler, build_telemetry,
                                  get_registry)
from repro_torch.core.obs.tracing import clock_ns
from repro_torch.core.supervision import (FaultConfig, FaultInjector, ReplicaCrash,
                                          ReplicaSupervisor, RetryPolicy,
                                          call_with_retry)
from repro_torch.core.transfer_queue import TransferQueue
from repro_torch.core.workflow.events import EventLog
from repro_torch.core.workflow.weight_sync import (BroadcastWeightChannel,
                                                   StaggeredUpdateGroup,
                                                   WeightReceiver, WeightSender)


@dataclass
class WorkflowConfig:
    mode: str = "async"               # baseline | streaming | async
    num_rollout_workers: int = 2
    rollout_batch: int = 2            # prompts per generate() call
    train_micro_batch: int = 4        # samples per trainer fetch
    prompts_per_step: int = 4         # prompts consumed per training step
    group_size: int = 4               # G responses per prompt (GRPO)
    num_steps: int = 8
    staleness: int = 1
    staggered: bool = False           # sub-step async (Fig. 8d)
    num_storage_units: int = 2
    policy: Any = "fifo"           # str, or {task: str} for per-stage policy
    channel_bandwidth_gbps: float = 0.0
    extra_columns: tuple = ()      # e.g. ("ref_logprob",) for GRPO+KL
    metrics_jsonl: str = ""        # JSONL metrics-snapshot path ("" = off)
    metrics_interval_s: float = 0.25
    auto_size_workers: bool = False  # planner-size stages with num_workers=0
    elastic_interval_s: float = 0.0  # >0: live rebalance monitor cadence (s)
    max_stage_workers: int = 8       # auto-size / elastic pool cap
    # -- supervision & fault tolerance (generator fleet) -----------------
    supervise: bool = True           # heartbeats + crash respawn + requeue
    max_replica_restarts: int = 8    # fleet-wide respawn budget
    heartbeat_timeout_s: float = 10.0  # stale replica declared dead (hung)
    max_stage_retries: int = 2       # extra attempts for RetryableError
    retry_backoff_s: float = 0.05    # base of exp backoff (+ determ. jitter)
    faults: Optional[FaultConfig] = None  # deterministic chaos injection
    # -- durable run checkpointing & trainer crash recovery ---------------
    checkpoint_dir: str = ""         # run-snapshot directory ("" = off)
    checkpoint_interval_steps: int = 1  # snapshot every N steps (0 = only
                                        # at run start/end + failure)
    checkpoint_keep_last: int = 3    # snapshot retention (keep-last-k)
    supervise_trainer: bool = True   # warm-restart the driver from the
                                     # newest snapshot on a trainer crash
    max_trainer_restarts: int = 4    # warm-restart budget

    @property
    def samples_per_step(self) -> int:
        return self.prompts_per_step * self.group_size


@dataclass
class WorkflowResult:
    wall_time_s: float
    samples_trained: int
    throughput: float                 # samples / s
    metrics: List[dict]
    staleness_seen: List[int]
    log: EventLog
    bubble_fraction: Dict[str, float] = field(default_factory=dict)
    aux_metrics: Dict[str, List[dict]] = field(default_factory=dict)
    # per-stage table + instance busy/wait + staleness quantiles + raw
    # MetricsRegistry snapshot (see repro_torch.core.obs.report)
    telemetry: Dict[str, Any] = field(default_factory=dict)


@dataclass
class StageSpec:
    """One RL task in the dataflow.

    Parameters
    ----------
    name: task name; becomes the TransferQueue controller name.
    inputs: columns that must be ready before a row is scheduled here.
    outputs: columns this stage writes (row updates, deferred writes, or
        columns of rows it spawns). ``version`` in a generate stage's
        outputs is written by the runner with the producing weight version.
    engine: key into the runner's engines dict.
    verb: RLAdapter method name resolved on that engine (ignored if ``fn``
        is given).
    fn: direct callable ``fn(batch, **ctx) -> stage output dict`` —
        used for pure-function stages (e.g. GAE) and legacy adapters.
    kind: "generate" (weight-receiving producer), "transform" (streaming
        map stage), "train" (the step-driving consumer), or
        "train_stream" (accumulating consumer without step semantics,
        e.g. critic updates).
    batch_size: rows per fetch; 0 uses the runner default for the kind.
    num_workers: worker threads; 0 uses the runner default for the kind.
    drives_steps: the single stage whose consumption defines training
        steps, weight publication and staleness accounting.
    kw: extra keyword arguments forwarded to every verb/fn call.
    """
    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...] = ()
    engine: str = ""
    verb: str = ""
    fn: Optional[Callable] = None
    kind: str = "transform"
    batch_size: int = 0
    num_workers: int = 0
    drives_steps: bool = False
    kw: dict = field(default_factory=dict)


class StageGraph:
    """A DAG of :class:`StageSpec` over a shared column namespace.

    ``source_columns`` are produced externally (the prompt feeder);
    every other input column must be produced by exactly one stage.
    """

    def __init__(self, source_columns: Sequence[str] = ("prompt",)):
        self.source_columns = tuple(source_columns)
        self.stages: Dict[str, StageSpec] = {}

    def add(self, spec: StageSpec) -> "StageGraph":
        if spec.name in self.stages:
            raise ValueError(f"duplicate stage {spec.name!r}")
        self.stages[spec.name] = spec
        return self

    def tasks(self) -> Dict[str, List[str]]:
        """{task_name: required columns} — the TransferQueue layout."""
        return {n: list(s.inputs) for n, s in self.stages.items()}

    def producers(self) -> Dict[str, str]:
        """column -> producing stage; raises on duplicate producers."""
        prod: Dict[str, str] = {}
        for s in self.stages.values():
            for c in s.outputs:
                if c in prod:
                    raise ValueError(
                        f"column {c!r} produced by both {prod[c]!r} "
                        f"and {s.name!r}")
                if c in self.source_columns:
                    raise ValueError(
                        f"stage {s.name!r} produces source column {c!r}")
                prod[c] = s.name
        return prod

    def validate(self) -> None:
        prod = self.producers()
        for s in self.stages.values():
            for c in s.inputs:
                if c not in self.source_columns and c not in prod:
                    raise ValueError(
                        f"stage {s.name!r} input column {c!r} has no "
                        f"producer (source columns: {self.source_columns})")
        self.topo_order()   # raises on cycles

    def topo_order(self) -> List[StageSpec]:
        """Kahn's algorithm over stage dependencies; raises on cycles."""
        prod = self.producers()
        deps: Dict[str, set] = {n: set() for n in self.stages}
        for s in self.stages.values():
            for c in s.inputs:
                p = prod.get(c)
                if p is not None and p != s.name:
                    deps[s.name].add(p)
                elif p == s.name:
                    raise ValueError(
                        f"stage {s.name!r} consumes its own output {c!r}")
        order, ready = [], [n for n, d in deps.items() if not d]
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m, d in deps.items():
                d.discard(n)
                if not d and m not in order and m not in ready:
                    ready.append(m)
        if len(order) != len(self.stages):
            cyc = sorted(set(self.stages) - set(order))
            raise ValueError(f"stage graph has a cycle involving {cyc}")
        return [self.stages[n] for n in order]


# -- dataflow registry (§5.1: algorithms declare graphs; users register) ----

_DATAFLOWS: Dict[str, Callable[..., StageGraph]] = {}


def register_dataflow(name: str, builder: Callable[..., StageGraph]) -> None:
    """Register a named dataflow builder (``builder(**kw) -> StageGraph``)."""
    _DATAFLOWS[name] = builder


def build_dataflow(name: str, **kw) -> StageGraph:
    if name not in _DATAFLOWS:
        # built-in dataflows register on algorithm-module import; loaded
        # lazily here so the core layer never hard-depends on the rl layer
        import repro_torch.rl  # noqa: F401
    if name not in _DATAFLOWS:
        raise KeyError(f"unknown dataflow {name!r}; "
                       f"registered: {sorted(_DATAFLOWS)}")
    return _DATAFLOWS[name](**kw)


class StageRunner:
    """Compiles a :class:`StageGraph` onto one shared TransferQueue and
    drives it under the configured workflow mode.

    Engines are passed as ``{key: engine}``; each stage resolves its verb
    on ``engines[spec.engine]`` unless it carries a direct ``fn``.
    The weight path (channel / sender / per-worker receivers, §4.2.3) is
    wired between the step-driving train stage and the generate stage.
    """

    def __init__(self, cfg: WorkflowConfig, graph: StageGraph, *,
                 engines: Dict[str, Any],
                 prompt_stream: Callable[[int], List[Any]],
                 log: Optional[EventLog] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 resume: Optional[dict] = None):
        """``resume`` is a run-snapshot document (``RunCheckpointer.load``)
        for cold resume: the runner starts at the snapshot's step, the
        feeder re-primes prompts from the dataset cursor, and the queue
        continues the snapshot's uid space (caller restores the engine
        states before constructing the runner)."""
        graph.validate()
        self.cfg = cfg
        self.graph = graph
        self.engines = dict(engines)
        self.prompt_stream = prompt_stream
        self.log = log or EventLog()
        self.registry = metrics if metrics is not None else get_registry()
        self._resume = resume
        resume_step = int(resume["step"]) if resume else 0
        resume_uid = int(resume.get("queue", {}).get("next_uid", 0)) \
            if resume else 0
        # declare stage kinds in topo order so gantt symbols for custom
        # stages are deterministic across runs
        self.log.register_kinds([s.name for s in graph.topo_order()])

        gens = [s for s in graph.stages.values() if s.kind == "generate"]
        drivers = [s for s in graph.stages.values() if s.drives_steps]
        if len(gens) != 1:
            raise ValueError(f"need exactly one generate stage, got "
                             f"{[s.name for s in gens]}")
        if len(drivers) != 1:
            raise ValueError(f"need exactly one drives_steps stage, got "
                             f"{[s.name for s in drivers]}")
        self.gen_stage = gens[0]
        self.driver_stage = drivers[0]
        self.transform_stages = [s for s in graph.stages.values()
                                 if s.kind == "transform"]
        self.stream_train_stages = [s for s in graph.stages.values()
                                    if s.kind == "train_stream"]

        total_rows = cfg.num_steps * cfg.samples_per_step
        # partial rollout requeues continuations as fresh source rows —
        # reserve capacity for every chunk of every group member
        gen_engine = self.engines.get(self.gen_stage.engine)
        chunk = getattr(gen_engine, "chunk_tokens", 0)
        cont_mult = 0
        if chunk:
            max_new = getattr(gen_engine, "max_new_tokens", chunk)
            cont_mult = cfg.group_size * (-(-max_new // chunk))
        capacity = (cfg.num_steps * cfg.prompts_per_step * (1 + cont_mult)
                    + total_rows)
        self.tq = TransferQueue(
            capacity=capacity, tasks=graph.tasks(),
            num_storage_units=cfg.num_storage_units, policy=cfg.policy,
            metrics=self.registry, uid_start=resume_uid)

        driver_engine = self.engines[self.driver_stage.engine] \
            if self.driver_stage.engine else None
        init_weights = getattr(driver_engine, "params", None)
        if init_weights is None:
            raise ValueError(
                f"drives_steps stage {self.driver_stage.name!r} must name "
                f"an engine exposing .params — the step driver publishes "
                f"weights to the generate stage at every step boundary")

        # ---- planner-driven worker sizing (§4.3 meets §3.3) ------------
        # every stage carries a desired pool size: hand-tuned num_workers
        # wins; specs left at 0 take the cfg default or — with
        # auto_size_workers — the cost-model sizing from
        # core/planner/elastic. Train-side stages stay single-threaded
        # (step semantics and engine gradient-accumulation state).
        self._pool_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._spawn_seq = 0
        self._active: Dict[str, int] = {n: 0 for n in graph.stages}
        self._desired: Dict[str, int] = {}
        for name, spec in graph.stages.items():
            if spec.drives_steps or spec.kind in ("train", "train_stream"):
                self._desired[name] = 1
            elif spec.kind == "generate":
                self._desired[name] = (spec.num_workers
                                       or cfg.num_rollout_workers)
            else:
                self._desired[name] = spec.num_workers or 1
        self.stage_costs = None
        if cfg.auto_size_workers:
            from repro_torch.core.planner.elastic import (auto_size_workers,
                                                          estimate_stage_costs)
            self.stage_costs = estimate_stage_costs(
                graph, self.engines,
                seq_len=int(getattr(driver_engine, "seq_len", 32)),
                group_size=cfg.group_size)
            sized = auto_size_workers(graph, self.stage_costs,
                                      max_workers=cfg.max_stage_workers)
            for name, spec in graph.stages.items():
                if spec.num_workers == 0 and not spec.drives_steps \
                        and spec.kind in ("generate", "transform"):
                    self._desired[name] = sized[name]
        self.n_gen_workers = self._desired[self.gen_stage.name]
        self._elastic = None

        # one-to-many broadcast: the trainer stages ONE host snapshot per
        # step and every replica swaps from the same buffer, acking the
        # version it runs — bytes published are independent of fleet size
        self.channel = BroadcastWeightChannel(cfg.channel_bandwidth_gbps,
                                              metrics=self.registry)
        self.sender = WeightSender(
            self.channel, mode="async" if cfg.mode == "async" else "sync",
            metrics=self.registry)
        self.receivers = [
            WeightReceiver(self.channel, init_weights, version=resume_step,
                           metrics=self.registry, replica_id=i)
            for i in range(self.n_gen_workers)]
        self.stagger = StaggeredUpdateGroup(self.receivers) \
            if cfg.staggered else None
        self._driver_engine = driver_engine

        self.trainer_version = resume_step
        self._stop = threading.Event()
        self._step_done = threading.Condition()
        self.staleness_seen: List[int] = []
        self.metrics: List[dict] = []
        self.aux_metrics: Dict[str, List[dict]] = {}
        self.samples_trained = 0
        self._error: Optional[str] = None
        self._error_origin: Optional[Tuple[str, Any]] = None
        self._fail_lock = threading.Lock()

        # ---- durable run checkpointing & trainer recovery ---------------
        self._ckpt = None
        if cfg.checkpoint_dir:
            from repro_torch.core.recovery import RunCheckpointer
            self._ckpt = RunCheckpointer(
                cfg.checkpoint_dir, keep_last=cfg.checkpoint_keep_last,
                metrics=self.registry)
        self._train_step = resume_step    # next step the driver runs
        self._feed_start = resume_step    # dataset/prompt-feed cursor
        self._trainer_epoch = 0           # bumped per warm restart (fence)
        self._trainer_restarts = 0
        self._last_snapshot_step = resume_step if resume else -1
        self._acked_uids: set = set()     # consumed watermark (dup guard)
        self._step_leases: List[Tuple[int, List[int]]] = []  # current step
        self._commit_pending: List[Tuple[int, List[int]]] = []  # completed
        if resume:
            self.metrics = [dict(m) for m in resume.get("metrics", [])]
            self.staleness_seen = [int(s) for s in
                                   resume.get("staleness_seen", [])]
            self.aux_metrics = {k: [dict(m) for m in v] for k, v in
                                (resume.get("aux_metrics") or {}).items()}
            self.samples_trained = int(resume.get(
                "samples_trained", resume_step * cfg.samples_per_step))
            self._acked_uids = set(resume.get("acked_uids", []))

        # ---- supervision & fault tolerance -----------------------------
        faults = cfg.faults
        self._faults = FaultInjector(faults, metrics=self.registry) \
            if faults is not None and faults.active else None
        self._retry_policy = RetryPolicy(
            max_attempts=cfg.max_stage_retries + 1,
            base_s=cfg.retry_backoff_s,
            seed=faults.seed if faults is not None else 0)
        self._supervisor: Optional[ReplicaSupervisor] = None
        if cfg.supervise:
            self._supervisor = ReplicaSupervisor(
                self._respawn_replica, requeue=self._requeue_replica,
                heartbeat_timeout_s=cfg.heartbeat_timeout_s,
                max_restarts=cfg.max_replica_restarts,
                on_exhausted=lambda e: self._fail(
                    self.gen_stage.name, "supervisor", e),
                stage=self.gen_stage.name, metrics=self.registry)

        # per-stage worker instrumentation (shared families, stage labels)
        m = self.registry
        self._h_batch = m.histogram(
            "stage_batch_seconds", "per-stage batch latency")
        self._c_samples = m.counter(
            "stage_samples_total", "samples produced/consumed per stage")
        self._c_tokens = m.counter(
            "stage_tokens_total", "tokens generated per stage")
        self._c_stalls = m.counter(
            "stage_stalls_total",
            "empty fetches: the stage polled with no rows ready "
            "(upstream backpressure)")
        self._h_staleness = m.histogram(
            "train_staleness",
            "observed weight-version staleness at the train consumer")
        self._g_workers = m.gauge(
            "stage_workers", "live worker threads per stage (elastic)")
        self._c_retries = m.counter(
            "stage_retries_total",
            "retryable stage failures retried in place (backoff)")
        self._c_trainer_restarts = m.counter(
            "trainer_restarts_total",
            "warm trainer restarts from a run snapshot")
        self._c_dup_dropped = m.counter(
            "rows_dropped_duplicate_total",
            "fetched rows past the durable consumed watermark dropped by "
            "the duplicate guard (never double-trained)")

    def _fail(self, stage: str, worker: Any, err: Any) -> None:
        """Record a fatal stage error and stop the run; run() re-raises.
        The FIRST failure wins when workers race (later ones are
        symptoms of the stop, not causes) and the message names the
        originating stage and worker index."""
        with self._fail_lock:
            if self._error is None:
                self._error = f"stage {stage!r} worker {worker}: {err!r}"
                self._error_origin = (stage, worker)
        self._stop.set()
        # wake any consumer blocked in tq.get() — a fatal error is
        # terminal, so waiting out the fetch timeout only delays the
        # unwind (and the final-flush / last-snapshot failure path)
        self.tq.close()
        with self._step_done:
            self._step_done.notify_all()

    # ------------------------------------------------------------------ #
    # helpers                                                             #
    # ------------------------------------------------------------------ #

    def _stage_fn(self, spec: StageSpec) -> Callable:
        if spec.fn is not None:
            return spec.fn
        return getattr(self.engines[spec.engine], spec.verb)

    @property
    def _source_col(self) -> str:
        return self.graph.source_columns[0]

    def _call_stage(self, stage: str, widx: int, thunk: Callable) -> Any:
        """Run one stage verb under the error taxonomy: deterministic
        fault injection first (chaos arm), then bounded retries with
        exponential backoff + deterministic jitter for RetryableError.
        ReplicaCrash and fatal errors propagate to _guard."""
        def _attempt():
            if self._faults is not None:
                self._faults.check(stage, widx)
            return thunk()

        return call_with_retry(
            _attempt, policy=self._retry_policy, key=f"{stage}:{widx}",
            on_retry=lambda a, e: self._c_retries.inc(stage=stage))

    # ------------------------------------------------------------------ #
    # replica supervision (generator fleet)                               #
    # ------------------------------------------------------------------ #

    def _requeue_replica(self, dead) -> int:
        """Supervisor requeue hook: return a dead replica's in-flight rows
        to the FRONT of the ready set (idempotent — a crashing replica
        requeues its own lease before reporting death) and release its
        broadcast subscription and pool slot."""
        n = self.tq.requeue(self.gen_stage.name, dead.current_lease)
        n += self.tq.requeue_consumer(self.gen_stage.name,
                                      f"rollout-{dead.rid}")
        dead.current_lease = None
        self.channel.unsubscribe(dead.rid)
        with self._pool_lock:
            if self._active[self.gen_stage.name] > 0:
                self._active[self.gen_stage.name] -= 1
                self._g_workers.labels(stage=self.gen_stage.name).set(
                    self._active[self.gen_stage.name])
        return n

    def _respawn_replica(self, dead) -> bool:
        """Supervisor respawn hook: start a replacement generate worker
        with a fresh receiver subscribed at the live trainer version."""
        if self._stop.is_set():
            return False
        spec = self.gen_stage
        with self._pool_lock:
            if self._active[spec.name] >= self._desired[spec.name]:
                return False        # elastic shrink absorbed the slot
            self._active[spec.name] += 1
            self._g_workers.labels(stage=spec.name).set(
                self._active[spec.name])
            self._spawn_worker(spec)
        return True

    # ------------------------------------------------------------------ #
    # elastic worker pools (planner-driven sizing + live rebalance)       #
    # ------------------------------------------------------------------ #

    def _pool_shrunk(self, name: str) -> bool:
        """Elastic shrink: the first worker to observe its pool above the
        desired size exits and returns its slot."""
        with self._pool_lock:
            if self._active[name] > self._desired[name]:
                self._active[name] -= 1
                self._g_workers.labels(stage=name).set(self._active[name])
                return True
        return False

    def _spawn_worker(self, spec: StageSpec) -> None:
        """Start one more worker thread for a stage (caller holds
        _pool_lock and has already counted the slot in _active)."""
        sid = self._spawn_seq
        self._spawn_seq = sid + 1
        if spec.kind == "generate":
            # a receiver constructed mid-run starts from the live trainer
            # params and catches up to the newest published version on its
            # first maybe_swap(); the broadcast channel tracks its acks
            # under a fresh replica id
            recv = WeightReceiver(self.channel, self._driver_engine.params,
                                  version=self.trainer_version,
                                  metrics=self.registry, replica_id=sid)
            self.receivers.append(recv)
            handle = self._supervisor.register(sid, None) \
                if self._supervisor is not None else None
            t = threading.Thread(
                target=self._guard,
                args=(self._generate_worker, sid, recv, handle),
                kwargs=dict(stage=spec.name, worker=sid, handle=handle),
                daemon=True)
            if handle is not None:
                handle.thread = t
        else:
            t = threading.Thread(
                target=self._guard, args=(self._transform_worker, spec, sid),
                kwargs=dict(stage=spec.name, worker=sid), daemon=True)
        self._threads.append(t)
        t.start()

    def _resize_stage(self, name: str, delta: int) -> bool:
        """ElasticController apply hook: grow/shrink a stage's pool.
        Train-side stages and (under staggered update) the generate stage
        are fixed-size."""
        spec = self.graph.stages.get(name)
        if spec is None or spec.drives_steps \
                or spec.kind not in ("generate", "transform"):
            return False
        if spec.kind == "generate" and self.cfg.staggered:
            return False            # staggered update group is fixed-size
        with self._pool_lock:
            new = self._desired[name] + delta
            if not 1 <= new <= self.cfg.max_stage_workers:
                return False
            self._desired[name] = new
            if delta > 0:
                if self._stop.is_set():
                    return False
                self._active[name] += 1
                self._g_workers.labels(stage=name).set(self._active[name])
                self._spawn_worker(spec)
        return True

    def _elastic_loop(self) -> None:
        while not self._stop.wait(self.cfg.elastic_interval_s):
            self._elastic.step()

    # ------------------------------------------------------------------ #
    # generate stage (weight-receiving producer)                          #
    # ------------------------------------------------------------------ #

    def _put_rows(self, spec: StageSpec, out_cols, rows, version,
                  c_samples, c_tokens) -> bool:
        """Write finished experience rows into the TransferQueue (the
        shared tail of batch-return and per-sample emit paths). Returns
        False after failing the run on capacity overflow."""
        if not rows:
            return True
        idxs = self.tq.next_indices(len(rows))
        if idxs[-1] >= self.tq.capacity:
            # beyond-capacity rows would be silently unschedulable
            # (controllers ignore out-of-range notifications) — fail
            # loudly instead: the graph's fan-out exceeds what the
            # cfg-derived capacity accounts for
            self._fail(spec.name, "producer", RuntimeError(
                f"overflowed queue capacity {self.tq.capacity} "
                f"(row {idxs[-1]}): generate fan-out exceeds "
                f"cfg.group_size accounting"))
            return False
        token_lens = [r.get("token_len", 0) for r in rows]
        c_samples.inc(len(rows))
        c_tokens.inc(sum(token_lens))
        for j, col in enumerate(out_cols):
            self.tq.put_batch(idxs, col, [r.get(col) for r in rows],
                              token_lens=token_lens if j == 0 else None)
        if "version" in spec.outputs:
            self.tq.put_batch(idxs, "version", [version] * len(rows))
        return True

    def _generate_worker(self, widx: int, recv: WeightReceiver,
                         handle=None) -> None:
        spec = self.gen_stage
        name = f"rollout-{widx}"
        rng = np.random.default_rng(1234 + widx)
        fn = self._stage_fn(spec)
        bs = spec.batch_size or self.cfg.rollout_batch
        out_cols = [c for c in spec.outputs if c != "version"]
        h_batch = self._h_batch.labels(stage=spec.name)
        c_samples = self._c_samples.labels(stage=spec.name)
        c_tokens = self._c_tokens.labels(stage=spec.name)
        c_stalls = self._c_stalls.labels(stage=spec.name)
        # per-sample handoff: a verb that accepts ``emit`` streams each
        # finished row into the queue the moment its sequence completes
        # (continuous batching), instead of returning them as one batch;
        # a verb that accepts ``heartbeat`` keeps the supervisor fed
        # during long rollouts so healthy replicas are never fenced
        try:
            sig = inspect.signature(fn).parameters
            supports_emit = "emit" in sig
            supports_heartbeat = "heartbeat" in sig
        except (TypeError, ValueError):
            supports_emit = supports_heartbeat = False
        while not self._stop.is_set():
            if handle is not None:
                if handle.fenced:
                    return     # declared dead; lease already requeued
                handle.beat()
            if self._pool_shrunk(spec.name):
                # the receiver stays listed for the channel's bookkeeping;
                # its device copy of the weights goes with the worker
                recv.params = None
                return
            # prompts are fetched under a lease: until this worker acks,
            # the supervisor can requeue them (front of ready set) if the
            # worker dies — no row is ever lost or handed out twice
            batch = self.tq.get(spec.name, bs, consumer=name, timeout=0.05,
                                allow_partial=True, lease=True)
            if batch is None:
                if self.tq.controllers[spec.name]._closed:
                    return
                c_stalls.inc()
                continue
            lease = batch.pop("lease", None)
            if handle is not None:
                handle.current_lease = lease
            batch.pop("indices", None)

            # ---- weight policy at the generation-iteration boundary ----
            # (checked after the prompt fetch so a worker can never pair
            # next-step prompts with pre-publish weights)
            if self.cfg.mode == "async":
                if self.stagger is not None:
                    if recv.staged_version() > recv.version and \
                            self.stagger.try_begin_update(widx):
                        with self.log.span(name, "weight_sync"):
                            recv.maybe_swap()
                        self.stagger.end_update(widx)
                else:
                    recv.maybe_swap()          # delayed update: H2D only
                floor = self.trainer_version - self.cfg.staleness
                if recv.version < floor:       # staleness gate
                    with self.log.span(name, "weight_sync"):
                        recv.wait_and_swap(floor, timeout=30.0)
            else:
                # sync modes: strictly on-policy — wait for current weights
                if recv.version < self.trainer_version:
                    with self.log.span(name, "weight_sync"):
                        recv.wait_and_swap(self.trainer_version,
                                           timeout=30.0)

            if handle is not None:
                handle.beat()      # weight waits above may be long
            n_in = len(batch[self._source_col])
            t_gen = time.monotonic()
            call_kw = dict(spec.kw)
            if supports_emit:
                v = recv.version
                # a fenced replica must not write rows: the supervisor
                # already requeued its lease, so anything this zombie
                # emits would be a duplicate
                call_kw["emit"] = lambda row: (
                    True if handle is not None and handle.fenced
                    else self._put_rows(spec, out_cols, [row], v,
                                        c_samples, c_tokens))
            if supports_heartbeat and handle is not None:
                call_kw["heartbeat"] = handle.beat
            with self.log.span(name, "generate", version=recv.version,
                               n=n_in):
                out = self._call_stage(
                    spec.name, widx,
                    lambda: fn(batch, params=recv.params, rng=rng,
                               version=recv.version, **call_kw)) or {}
            h_batch.observe(time.monotonic() - t_gen)

            if handle is not None and handle.fenced:
                # fenced mid-verb (hung-replica recovery): drop whatever
                # was not yet written and exit without acking — the
                # replacement regenerates from the requeued lease
                return
            conts = out.get("requeue") or []
            if conts:
                cidx = self.tq.next_indices(len(conts))
                self.tq.put_batch(cidx, self._source_col, conts,
                                  token_lens=[len(c["tokens"])
                                              for c in conts])
            if not self._put_rows(spec, out_cols, out.get("rows") or [],
                                  recv.version, c_samples, c_tokens):
                return
            # outputs durably in the queue -> finalize the lease
            self.tq.ack(spec.name, lease)
            if handle is not None:
                handle.current_lease = None

    # ------------------------------------------------------------------ #
    # transform stages (streaming map over rows)                          #
    # ------------------------------------------------------------------ #

    def _transform_worker(self, spec: StageSpec, widx: int) -> None:
        name = f"{spec.name}-{widx}"
        fn = self._stage_fn(spec)
        bs = spec.batch_size or self.cfg.train_micro_batch
        h_batch = self._h_batch.labels(stage=spec.name)
        c_samples = self._c_samples.labels(stage=spec.name)
        c_stalls = self._c_stalls.labels(stage=spec.name)
        while True:
            if self._pool_shrunk(spec.name):
                return
            batch = self.tq.get(spec.name, bs, consumer=name, timeout=0.05,
                                allow_partial=True)
            if batch is None:
                if self._stop.is_set() or \
                        self.tq.controllers[spec.name]._closed:
                    return
                c_stalls.inc()
                continue
            idxs = batch.pop("indices")
            t_fn = time.monotonic()
            with self.log.span(name, spec.name, n=len(idxs)):
                out = self._call_stage(
                    spec.name, widx,
                    lambda: fn(batch, indices=idxs, **spec.kw)) or {}
            h_batch.observe(time.monotonic() - t_fn)
            c_samples.inc(len(idxs))
            for col, vals in (out.get("updates") or {}).items():
                self.tq.put_batch(idxs, col, vals)
            for i, col, v in (out.get("writes") or []):
                self.tq.put(i, col, v)

    # ------------------------------------------------------------------ #
    # train stages (consumers)                                            #
    # ------------------------------------------------------------------ #

    def _driver(self) -> None:
        """Supervised step driver: runs :meth:`_driver_loop` under the
        trainer-recovery policy. A :class:`ReplicaCrash` out of the loop
        (chaos arm or a real trainer death) warm-restarts the loop from
        the newest intact run snapshot — same process, generate replicas
        keep streaming — until the restart budget is spent, after which
        the crash propagates and fails the run loudly."""
        cfg = self.cfg
        if self._ckpt is not None and \
                self._last_snapshot_step < self._train_step:
            self._write_snapshot(self._train_step)  # cover step-0 crashes
        while True:
            try:
                self._driver_loop()
            except ReplicaCrash as e:
                if self._stop.is_set():
                    return
                if not cfg.supervise_trainer or self._ckpt is None or \
                        self._trainer_restarts >= cfg.max_trainer_restarts:
                    raise
                self._recover_trainer(e)
                continue
            if self._ckpt is not None and self._error is None and \
                    self._last_snapshot_step != self._train_step:
                self._write_snapshot(self._train_step)  # clean shutdown
            return

    @staticmethod
    def _in_row_order(idxs, batch):
        """The step driver's rows in the order they were produced (by row
        index), not the order they became ready: its gradient sums over
        rows, and which row's last column lands first follows the
        upstream stages' timing, so two runs of one seed could add the
        same rows in another order."""
        order = sorted(range(len(idxs)), key=idxs.__getitem__)
        if order == list(range(len(idxs))):
            return idxs, batch
        return ([idxs[k] for k in order],
                {c: [v[k] for k in order] for c, v in batch.items()})

    def _driver_loop(self) -> None:
        """The step-driving consumer: defines training steps, publishes
        weights, records observed staleness. With a checkpointer attached
        it consumes under leases (acked only once a snapshot covering the
        step is durable) and drops rows already past the consumed
        watermark — exactly-once training across restarts."""
        spec = self.driver_stage
        name = "train-0"
        cfg = self.cfg
        fn = self._stage_fn(spec)
        h_batch = self._h_batch.labels(stage=spec.name)
        c_samples = self._c_samples.labels(stage=spec.name)
        h_staleness = self._h_staleness.labels(stage=spec.name)
        use_lease = self._ckpt is not None
        for step in range(self._train_step, cfg.num_steps):
            got = 0
            while got < cfg.samples_per_step and not self._stop.is_set():
                want = (cfg.samples_per_step - got
                        if cfg.mode == "baseline"
                        else min(cfg.train_micro_batch,
                                 cfg.samples_per_step - got))
                t0 = clock_ns()
                batch = self.tq.get(spec.name, want, consumer=name,
                                    timeout=60.0, lease=use_lease)
                self.log.record(name, "wait", t0, clock_ns())
                if batch is None:
                    self._stop.set()
                    return
                lease = batch.pop("lease", None)
                idxs = batch.pop("indices", None) or []
                if use_lease and idxs:
                    # consumed-watermark duplicate guard: rows acked in a
                    # durable snapshot must never train twice (the window
                    # between snapshot write and lease ack requeues rows
                    # that are already in the acked set)
                    keep = [k for k, i in enumerate(idxs)
                            if i not in self._acked_uids]
                    if len(keep) < len(idxs):
                        self._c_dup_dropped.inc(len(idxs) - len(keep))
                        if not keep:
                            self.tq.ack(spec.name, lease)
                            continue
                        idxs = [idxs[k] for k in keep]
                        batch = {c: [v[k] for k in keep]
                                 for c, v in batch.items()}
                idxs, batch = self._in_row_order(idxs, batch)
                if lease is not None:
                    # tracked before the update: a crash inside fn()
                    # leaves the lease unacked, so recovery requeues
                    # this batch along with the rest of the step
                    self._step_leases.append((lease, list(idxs)))
                versions = batch.get("version")
                n = len(versions) if versions is not None \
                    else len(batch[spec.inputs[0]])
                for v in (versions or []):
                    s = self.trainer_version - v
                    self.staleness_seen.append(s)
                    h_staleness.observe(s)
                t_up = time.monotonic()
                with self.log.span(name, "update", step=step, n=n):
                    m = self._call_stage(spec.name, 0, lambda: fn(batch))
                h_batch.observe(time.monotonic() - t_up)
                c_samples.inc(n)
                if m:
                    self.metrics.append({"step": step, **m})
                got += n
                self.samples_trained += n
            if self._stop.is_set() and got < cfg.samples_per_step:
                return

            # step complete -> publish new weights
            with self.log.span(name, "weight_sync", version=step + 1):
                self.sender.publish(self._driver_engine.params, step + 1)
                if cfg.mode != "async":
                    self.sender.flush()
            with self._step_done:
                self.trainer_version = step + 1
                self._step_done.notify_all()
            self._train_step = step + 1
            if use_lease:
                self._commit_pending.extend(self._step_leases)
                del self._step_leases[:]
                if cfg.checkpoint_interval_steps > 0 and \
                        (step + 1) % cfg.checkpoint_interval_steps == 0:
                    self._write_snapshot(step + 1)

    # ------------------------------------------------------------------ #
    # durable run snapshots & trainer recovery                            #
    # ------------------------------------------------------------------ #

    def _rollout_cursor(self, version: int) -> dict:
        """Deterministic rollout-counter bases at a step boundary. Live
        engine counters race with generation for *later* steps, so the
        bases derive from the fixed per-step feed schedule instead: by
        boundary V exactly V*prompts_per_step groups and
        V*samples_per_step sequences are final."""
        cfg = self.cfg
        return {"gid": int(version) * cfg.prompts_per_step,
                "cb_next_uid": int(version) * cfg.samples_per_step}

    def _write_snapshot(self, version: int) -> None:
        """Persist the run at a step boundary, then ack the leases the
        snapshot covers (ack-on-snapshot: rows only pass the durable
        consumed watermark once the snapshot naming them acked is on
        disk — a crash in between requeues rows that are also in the
        acked set, and the duplicate guard drops them; exactly-once
        either way)."""
        cfg = self.cfg
        pending = list(self._commit_pending)
        acked = set(self._acked_uids)
        for _lease, idxs in pending:
            acked.update(idxs)
        run_state = {
            "trainer_version": int(version),
            "feed_step": int(version),
            "samples_trained": min(self.samples_trained,
                                   int(version) * cfg.samples_per_step),
            "metrics": [dict(m) for m in self.metrics],
            "staleness_seen": [int(s) for s in self.staleness_seen],
            "aux_metrics": {k: [dict(m) for m in v]
                            for k, v in self.aux_metrics.items()},
            "acked_uids": sorted(acked),
            "queue": self.tq.cursor(),
            "rollout": self._rollout_cursor(version),
            "trainer_restarts": self._trainer_restarts,
        }
        # every engine exposing a .state pytree is bundled (actor, critic);
        # streaming aux engines are captured best-effort mid-stream
        engine_states = {k: e.state for k, e in self.engines.items()
                         if hasattr(e, "state")}
        self._ckpt.save(int(version), run_state, engine_states)
        self._last_snapshot_step = int(version)
        for lease, idxs in pending:
            self.tq.ack(self.driver_stage.name, lease)
            self._acked_uids.update(idxs)
        del self._commit_pending[:len(pending)]

    def _recover_trainer(self, err) -> None:
        """Warm-restart the train stage inside the live process: fence
        the dead driver's partial work, requeue its unacked leases (front
        of ready, original consumption order), and rewind the driver
        engine + run accounting to the newest intact snapshot. Generate
        replicas keep streaming throughout — the weight channel retains
        any versions published past the snapshot, and the redone steps
        recompute identical weights, so re-publishes are no-ops."""
        spec = self.driver_stage
        self._trainer_restarts += 1
        self._trainer_epoch += 1
        self._c_trainer_restarts.inc()
        # fence: drop the dead driver's partial gradient accumulation so
        # stale optimizer writes can never land on the restored state
        del self._step_leases[:]
        del self._commit_pending[:]
        self.tq.requeue_consumer(spec.name, "train-0")
        path = self._ckpt.resolve("auto")
        if path is None:
            raise RuntimeError(
                f"trainer crashed ({err!r}) with no intact run snapshot "
                f"in {self.cfg.checkpoint_dir!r}")
        doc = self._ckpt.load(path)
        step = int(doc["step"])
        eng = self._driver_engine
        if hasattr(eng, "state"):
            eng.state, _ = self._ckpt.load_engine(
                path, self.driver_stage.engine, eng.state)
        for attr, val in (("_accum", None), ("_accum_n", 0),
                          ("_accum_metrics", []), ("version", step)):
            if hasattr(eng, attr):
                setattr(eng, attr, val)
        # rewind run accounting IN PLACE (WorkflowResult aliases these)
        del self.metrics[:]
        self.metrics.extend(dict(m) for m in doc.get("metrics", []))
        del self.staleness_seen[:]
        self.staleness_seen.extend(int(s)
                                   for s in doc.get("staleness_seen", []))
        self.samples_trained = int(doc.get(
            "samples_trained", step * self.cfg.samples_per_step))
        self._acked_uids = set(doc.get("acked_uids", []))
        self._last_snapshot_step = step
        with self._step_done:
            self.trainer_version = step
            self._train_step = step
            self._step_done.notify_all()

    def _stream_train_worker(self, spec: StageSpec) -> None:
        """Accumulating consumer without step semantics (e.g. the critic):
        streams micro-batches until the run stops, then drains."""
        name = f"{spec.name}-0"
        fn = self._stage_fn(spec)
        bs = spec.batch_size or self.cfg.train_micro_batch
        sink = self.aux_metrics.setdefault(spec.name, [])
        h_batch = self._h_batch.labels(stage=spec.name)
        c_samples = self._c_samples.labels(stage=spec.name)
        c_stalls = self._c_stalls.labels(stage=spec.name)
        while True:
            batch = self.tq.get(spec.name, bs, consumer=name, timeout=0.05,
                                allow_partial=True)
            if batch is None:
                if self._stop.is_set() or \
                        self.tq.controllers[spec.name]._closed:
                    return
                c_stalls.inc()
                continue
            batch.pop("indices", None)
            n = len(batch[spec.inputs[0]])
            t_fn = time.monotonic()
            with self.log.span(name, spec.name, n=n):
                m = self._call_stage(spec.name, 0, lambda: fn(batch))
            h_batch.observe(time.monotonic() - t_fn)
            c_samples.inc(n)
            if m:
                sink.append(m)

    # ------------------------------------------------------------------ #
    # prompt feeder — per-mode release schedule                           #
    # ------------------------------------------------------------------ #

    def _feed_prompts(self) -> None:
        cfg = self.cfg
        ahead = cfg.staleness if cfg.mode == "async" else 0
        # a cold-resumed run re-primes generation from the dataset cursor:
        # prompts below the snapshot step were trained and acked already
        for step in range(self._feed_start, cfg.num_steps):
            with self._step_done:
                while self.trainer_version < step - ahead and \
                        not self._stop.is_set():
                    self._step_done.wait(0.05)
            if self._stop.is_set():
                break
            prompts = self.prompt_stream(step)
            idxs = self.tq.next_indices(len(prompts))
            self.tq.put_batch(idxs, self._source_col, prompts,
                              token_lens=[len(p) if hasattr(p, "__len__")
                                          else 0 for p in prompts])
        self.tq.close_task(self.gen_stage.name)

    # ------------------------------------------------------------------ #
    # lifecycle                                                           #
    # ------------------------------------------------------------------ #

    def _guard(self, target, *args, stage: str = "run", worker: Any = -1,
               handle=None) -> None:
        """Worker-thread wrapper routing failures through the error
        taxonomy: :class:`ReplicaCrash` on a supervised generate replica
        triggers fleet recovery (lease requeue + respawn); anything else
        aborts the whole run loudly — attributed to its stage and worker
        — instead of dying as a silent daemon thread."""
        try:
            target(*args)
        except ReplicaCrash as e:
            if self._stop.is_set():
                return         # run already stopping; nothing to recover
            if handle is not None and self._supervisor is not None:
                # crash path: requeue our own lease synchronously so the
                # rows are back (in order) before the replacement spawns,
                # then report our death; the monitor respawns the slot
                self.tq.requeue(self.gen_stage.name, handle.current_lease)
                handle.current_lease = None
                self._supervisor.report_death(handle.rid, repr(e))
            else:
                self._fail(stage, worker, e)
        except Exception as e:                       # noqa: BLE001
            self._fail(stage, worker, e)
        else:
            if handle is not None and self._supervisor is not None:
                self._supervisor.retire(handle.rid)

    def run(self) -> WorkflowResult:
        sampler = None
        if self.cfg.metrics_jsonl:
            sampler = MetricsSampler(self.registry, self.cfg.metrics_jsonl,
                                     self.cfg.metrics_interval_s).start()
        t0 = time.monotonic()
        feeder = threading.Thread(
            target=self._guard, args=(self._feed_prompts,),
            kwargs=dict(stage="prompt_feeder", worker=0), daemon=True)
        gen_name = self.gen_stage.name
        with self._pool_lock:
            for i in range(self.n_gen_workers):
                handle = self._supervisor.register(i, None) \
                    if self._supervisor is not None else None
                t = threading.Thread(
                    target=self._guard,
                    args=(self._generate_worker, i, self.receivers[i],
                          handle),
                    kwargs=dict(stage=gen_name, worker=i, handle=handle),
                    daemon=True)
                if handle is not None:
                    handle.thread = t
                self._threads.append(t)
            for spec in self.transform_stages:
                for w in range(self._desired[spec.name]):
                    self._threads.append(threading.Thread(
                        target=self._guard,
                        args=(self._transform_worker, spec, w),
                        kwargs=dict(stage=spec.name, worker=w),
                        daemon=True))
            for spec in self.stream_train_stages:
                self._threads.append(threading.Thread(
                    target=self._guard,
                    args=(self._stream_train_worker, spec),
                    kwargs=dict(stage=spec.name, worker=0), daemon=True))
            # mid-run spawns pick worker ids above every initial index so
            # consumer names never collide within a stage
            self._spawn_seq = max(self._desired.values(), default=1)
            for name, n in self._desired.items():
                self._active[name] = n
                self._g_workers.labels(stage=name).set(n)
        monitor = None
        if self.cfg.elastic_interval_s > 0:
            from repro_torch.core.planner.elastic import ElasticController
            self._elastic = ElasticController(
                self.graph, self.registry, self._desired, self._resize_stage,
                max_workers=self.cfg.max_stage_workers)
            monitor = threading.Thread(target=self._elastic_loop, daemon=True)
        super_mon = None
        if self._supervisor is not None:
            super_mon = threading.Thread(
                target=self._supervisor.monitor, args=(self._stop,),
                daemon=True)
        trainer = threading.Thread(
            target=self._guard, args=(self._driver,),
            kwargs=dict(stage=self.driver_stage.name, worker=0), daemon=True)
        try:
            feeder.start()
            for w in self._threads:
                w.start()
            if monitor is not None:
                monitor.start()
            if super_mon is not None:
                super_mon.start()
            trainer.start()
            trainer.join()
            # an async publish may still be copying the last weights to
            # the host on its own thread: finish it before returning
            self.sender.flush()
            self._stop.set()
            self.tq.close()
            with self._pool_lock:
                threads = list(self._threads)
            for w in threads:
                w.join(timeout=5.0)
            feeder.join(timeout=5.0)
            if monitor is not None:
                monitor.join(timeout=5.0)
            if super_mon is not None:
                super_mon.join(timeout=5.0)
        finally:
            if self._ckpt is not None and self._error is not None and \
                    self._last_snapshot_step != self._train_step:
                # abnormal exit: flush one last snapshot at the newest
                # completed boundary so a cold resume can pick up there
                # (best-effort — never masks the original failure)
                try:
                    self._write_snapshot(self._train_step)
                except Exception:                         # noqa: BLE001
                    pass
            if sampler is not None:
                sampler.stop()
        if self._error is not None:
            raise RuntimeError(f"stage-graph run failed: {self._error}")
        wall = time.monotonic() - t0
        n = self.samples_trained
        return WorkflowResult(
            wall_time_s=wall, samples_trained=n, throughput=n / wall,
            metrics=self.metrics, staleness_seen=self.staleness_seen,
            log=self.log, bubble_fraction=self.log.bubble_fraction(),
            aux_metrics=self.aux_metrics,
            telemetry=build_telemetry(self.log, self.registry, wall, n,
                                      self.staleness_seen))
