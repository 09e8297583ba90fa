"""Fused round executor (the port of ``repro.engine.fused``): one
static-shape program per materialization round, captured as a CUDA graph
on the card.

The two-phase wrappers in ``repro_torch.engine.ops`` pull every
data-dependent count to the host (one blocking sync per primitive call) to
pick pow-2 output buckets; on small-delta rounds those host round-trips,
not the join arithmetic, set the pace.  This module removes them:

* The rule-plan IR (``repro_torch.engine.plan``: ``RulePlan`` /
  ``compile_rule_plan``), its capacity planner (``_Caps``) and the round
  pieces (``_exec_rule_traced`` / ``_absorb_traced``) are stitched into
  one program per (rule set, capacity plan): body filters, the Def. 23
  antijoin pre-restriction, the sort-merge join chain, head projection,
  and the per-predicate absorb (dedup + antijoin vs store + incremental
  sorted merge).  On the card the program is captured once per signature
  (``torch.cuda.CUDAGraph``) and replayed; its inputs are copied into the
  graph's input buffers.  The only device->host traffic per round is one
  int64 bundle: counts, the trigger total and the overflow vector
  (``HOST_SYNC_STATS.fused_pulls``).
* Once the remaining computation is *linear* — every still-active rule
  has exactly one body atom whose predicate can still change — the whole
  fixpoint runs as one device loop: one captured iteration under a
  conditional WHILE node (``repro_torch.kernels.graph_loop``), the
  counterpart of the reference's ``lax.while_loop``, with one pull per
  exit.  The loop state lives in fixed buffers that each iteration
  updates in place (where the reference donates its loop-state buffers to
  XLA).

On CPU tensors the same programs run as plain torch ops, and the fixpoint
loop is a host loop (``_HostLoop``, the device loop's plain version);
``fused_pulls`` is counted where the reference counts it either way: one
per round program, one per fixpoint exit.  On the card nothing runs
eagerly in place of a graph: a capture or a launch that fails raises.
Before its capture a program runs once eagerly on copies of its inputs
(lazy initialisation, scratch sizes); that run's results are dropped and
its kernel calls are not counted.  A replay adds the launches recorded at
capture to ``kernels.ops.launch_counts`` (per iteration, for the device
loop).

Overflow semantics: every planned capacity gets an in-program overflow
flag (``needed > planned``).  When any flag fires the round's outputs are
discarded, the host doubles exactly the overflowed capacities, builds (and
on the card captures) the program at the new buckets, drops the graph of
the superseded plan, and retries the same round from the inputs it still
holds (``HOST_SYNC_STATS.fused_retries``).  Inside the fixpoint loop an
overflow exits with the *last good* state, so the retry resumes
mid-fixpoint.

Eligibility: Datalog rules (no existentials) with connected bodies.
``materialize()`` falls back to the two-phase executor for anything else.
"""
from __future__ import annotations

import torch

from repro_torch.engine import ops, recovery
from repro_torch.engine.plan import (_absorb_traced, _cached_program, _Caps,
                                     _drop_program, _exec_rule_traced,
                                     _linear_tail, _select_state,
                                     CapacityError, clear_programs,
                                     compile_rule_plan, program_fingerprint,
                                     RetryBudget, RulePlan)
from repro_torch.engine.relation import (Relation, host_order, lex_order,
                                         pad_of)
from repro_torch.kernels import graph_loop as GL
from repro_torch.kernels import ops as KO

__all__ = ["RulePlan", "clear_programs", "compile_rule_plan",
           "materialize_fused", "lower_fused_programs"]

# graphs captured since the last reset: the fused executor's round programs
# and fixpoint loops, and the sharded executor's (``engine/distributed.py``)
# round programs, fixpoint prologues and fixpoint loops
CAPTURES = {"round": 0, "fixpoint": 0,
            "dist_round": 0, "dist_prologue": 0, "dist_fixpoint": 0}


# ---------------------------------------------------------------------------
# running programs: plain torch ops on the CPU, captured graphs on the card
# ---------------------------------------------------------------------------
def _upload(values, device) -> torch.Tensor:
    """Host ints -> (n,) int64 on ``device``; on the card through pinned
    memory and an asynchronous copy, so the host does not wait."""
    t = torch.tensor(values, dtype=torch.int64)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _pull(bundle: torch.Tensor) -> list:
    """The one blocking device->host pull of a round program or of a
    fixpoint exit."""
    ops.HOST_SYNC_STATS.fused_pulls += 1
    return bundle.cpu().tolist()


def _stage(buffers, values) -> None:
    """Copy ``values`` into a captured program's input buffers (a value
    that already is its buffer is left alone)."""
    for buf, v in zip(buffers, values):
        if buf.data_ptr() == v.data_ptr():
            continue
        if buf.shape != v.shape or buf.dtype != v.dtype:
            raise ValueError(f"program input {tuple(v.shape)} {v.dtype} "
                             f"does not fit its buffer {tuple(buf.shape)} "
                             f"{buf.dtype}")
        buf.copy_(v)


def _capture(kind: str, fn, keep_graph: bool = False):
    try:
        out = GL.capture(fn, keep_graph=keep_graph)
    except Exception as e:
        raise RuntimeError(f"CUDA graph capture of a {kind} program "
                           f"failed: {e}") from e
    CAPTURES[kind] += 1
    return out


class _Eager:
    """A round program on CPU tensors: the function itself."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def held(self, args):
        return args


class _Replay:
    """A round program on the card.  The first call copies its inputs into
    buffers of the program's own, runs the function once on them (results
    dropped, calls not counted), captures it and replays; later calls copy
    their inputs in and replay.  Outputs live in the graph's memory pool
    and the next replay overwrites them; ``held`` gives back the inputs of
    the last call, which a replay leaves as they were.  The capture is
    counted under ``kind`` in ``CAPTURES``."""

    def __init__(self, fn, kind: str = "round"):
        self.fn = fn
        self.graph = None
        self.kind = kind

    def __call__(self, *args):
        if self.graph is None:
            self.static = [a.clone() for a in args]
            with KO.uncounted():
                self.fn(*self.static)
            self.graph, self.out, self.launches = _capture(
                self.kind, lambda: self.fn(*self.static))
        else:
            _stage(self.static, args)
        self.graph.replay()
        KO.add_launches(self.launches)
        return self.out

    def held(self, args):
        return self.static

    def close(self):
        self.graph = self.out = self.static = None


class _HostLoop:
    """The linear-tail loop as a host loop: while ``cond(scal)``, step.  On
    CPU tensors this is the fused executor's loop; it is the device loop's
    plain version."""

    def __init__(self, step, cond):
        self.step = step
        self.cond = cond

    def __call__(self, consts, state, enter=True):
        state = list(state)
        while bool(self.cond(state[-1])):
            state = list(self.step(consts, state))
        return state

    def count(self, iters):
        pass


class _DeviceLoop:
    """The linear-tail loop on the card: one captured iteration (reads the
    loop state from this program's buffers, writes the next state back,
    writes the continue flag) under a conditional WHILE node.  A call
    copies the constants and the initial state in and launches the loop
    once, if ``enter`` (the loop condition on entry) holds; it returns the
    state buffers, which hold the exit state once the stream reaches
    them.  The capture is counted under ``kind`` in ``CAPTURES``."""

    def __init__(self, step, cond, kind: str = "fixpoint"):
        self.step = step
        self.cond = cond
        self.loop = None
        self.kind = kind

    def _build(self, consts, state):
        self.consts = [c.clone() for c in consts]
        self.state = [s.clone() for s in state]
        self.cont = torch.zeros(1, dtype=torch.int32,
                                device=state[-1].device)
        with KO.uncounted():
            self.step(self.consts, self.state)

        def iteration():
            new = self.step(self.consts, self.state)
            cont = self.cond(new[-1])
            for buf, v in zip(self.state, new):
                buf.copy_(v)
            self.cont.copy_(cont.reshape(1))

        graph, _, self.launches = _capture(self.kind, iteration,
                                           keep_graph=True)
        try:
            self.loop = GL.WhileLoop(graph, self.cont)
        except RuntimeError as e:
            raise RuntimeError(f"{self.kind} program: {e}") from e

    def __call__(self, consts, state, enter=True):
        if self.loop is None:
            self._build(consts, state)
        else:
            _stage(self.consts, consts)
            _stage(self.state, state)
        if enter:
            self.loop.launch()
        return self.state

    def count(self, iters):
        """Add the launches of ``iters`` loop iterations."""
        KO.add_launches(self.launches, iters)

    def close(self):
        if self.loop is not None:
            self.loop.close()
        self.loop = self.consts = self.state = None


class _Program:
    """A built round or fixpoint program: ``run`` (plain torch ops on the
    CPU, captured on the card), its overflow ``labels`` and, for a round,
    the ``derived`` predicates whose deltas it returns."""

    def __init__(self, run, labels, derived=()):
        self.run = run
        self.labels = labels
        self.derived = derived

    def close(self):
        close = getattr(self.run, "close", None)
        if close is not None:
            close()


def _own(t: torch.Tensor) -> torch.Tensor:
    """A tensor the caller keeps: on the card, a copy out of whatever
    program buffer it may live in (the next replay would overwrite it)."""
    return t.clone() if t.is_cuda else t


# ---------------------------------------------------------------------------
# round program
# ---------------------------------------------------------------------------
def _round_signature(preds, caps, active, delta_in, use_prefilter, layout):
    return ("round", preds,
            tuple(caps.store[p] for p in preds),
            tuple((plan.key, jd, tuple(caps.join_cap(plan, i)
                                       for i in range(len(plan.joins))))
                  for plan, jd in active),
            tuple((p, caps.delta_cap(p)) for p in delta_in),
            tuple(sorted((p, caps.delta_cap(p)) for p in
                         {plan.head_pred for plan, _ in active})),
            use_prefilter, layout)


def _bundle(parts) -> torch.Tensor:
    return torch.stack([t.to(torch.int64) for t in parts])


def _build_round(preds, caps, active, delta_in, use_prefilter):
    """One materialization round as a single program.

    Inputs (flat): per-pred store blocks (at planner capacities), the (P,)
    int64 store counts, and the live delta blocks (at planner delta
    capacities).  Outputs (flat): the new stores, the new per-derived-pred
    deltas, and one int64 bundle: the new store counts, the delta counts,
    the round's trigger total and the overflow flags.  ``ovf_labels``
    names each overflow slot so the driver can double exactly the right
    capacity."""
    derived = tuple(sorted({plan.head_pred for plan, _ in active}))
    ovf_labels = []
    for plan, jd in active:
        for i in range(len(plan.joins)):
            ovf_labels.append(("join", (plan.key, i)))
    for pred in derived:
        ovf_labels.append(("delta", pred))
        ovf_labels.append(("store", pred))
    join_caps = {id(plan): tuple(caps.join_cap(plan, i)
                                 for i in range(len(plan.joins)))
                 for plan, _ in active}
    delta_caps = {p: caps.delta_cap(p) for p in derived}
    n = len(preds)

    def fn(*xs):
        stores = dict(zip(preds, xs[:n]))
        counts = dict(zip(preds, xs[n].unbind()))
        deltas = dict(zip(delta_in, xs[n + 1:]))
        triggers = torch.zeros((), dtype=torch.int64, device=xs[n].device)
        ovfs = []
        heads = {}
        for plan, jd in active:
            inputs = [deltas[bp] if j == jd else stores[bp]
                      for j, bp in enumerate(plan.body_preds)]
            pre_data = stores[plan.head_pred] if use_prefilter else None
            head, trg, jovfs = _exec_rule_traced(plan, inputs, pre_data,
                                                 join_caps[id(plan)])
            triggers = triggers + trg
            ovfs += jovfs
            heads.setdefault(plan.head_pred, []).append(head)
        out_deltas, out_dcounts = [], []
        for pred in derived:
            ns, nc, delta, nf, (od, os_) = _absorb_traced(
                heads[pred],
                lambda rows, p=pred: ~ops.member_mask_core(rows, stores[p]),
                stores[pred], counts[pred], delta_caps[pred])
            stores[pred] = ns
            counts[pred] = nc
            out_deltas.append(delta)
            out_dcounts.append(nf)
            ovfs += [od, os_]
        bundle = _bundle([*(counts[p] for p in preds), *out_dcounts,
                          triggers, *ovfs])
        return (*(stores[p] for p in preds), *out_deltas, bundle)

    return fn, ovf_labels, derived


def _round_program(preds, caps, active, delta_in, use_prefilter, device):
    fn, labels, derived = _build_round(preds, caps, active, delta_in,
                                       use_prefilter)
    run = _Replay(fn) if device.type == "cuda" else _Eager(fn)
    return _Program(run, labels, derived)


# ---------------------------------------------------------------------------
# fused fixpoint (one device loop over whole rounds)
# ---------------------------------------------------------------------------
def _fix_signature(s_preds, o_preds, caps, active, use_prefilter,
                   max_rounds, layout):
    return ("fix", s_preds, o_preds,
            tuple(caps.store[p] for p in s_preds + o_preds),
            tuple(caps.delta_cap(p) for p in s_preds),
            tuple(caps.tail_cap(p) for p in s_preds),
            tuple((plan.key, jd, tuple(caps.join_cap(plan, i)
                                       for i in range(len(plan.joins))))
                  for plan, jd in active),
            use_prefilter, max_rounds, layout)


def _build_fixpoint(s_preds, o_preds, caps, active, use_prefilter,
                    max_rounds):
    """The remaining (linear) fixpoint as one loop program.

    Constants: the phase-entry stores of the still-changing predicates
    (redundancy filtering probes base store | tail) and the other stores.
    Loop state (flat): a sorted *tail* buffer per changing predicate, its
    delta, and one int64 vector ``scal`` = [tail counts (S), delta counts
    (S), rounds, triggers, derived, iterations, overflow flags].  Each
    round's fresh facts merge into the tail (O(tail) work per iteration,
    not O(store)).  When a tail fills, the loop exits with the last good
    state, the host folds the tail into its store once, and the loop
    re-enters — the fixpoint resumes, never restarts.  Join/delta capacity
    overflows exit the same way and retry after host-side doubling.
    Returns (step, cond, ovf_labels): ``step(consts, state)`` is one
    iteration, ``cond(scal)`` the loop condition."""
    derived = tuple(sorted({plan.head_pred for plan, _ in active}))
    ovf_labels = []
    for plan, jd in active:
        for i in range(len(plan.joins)):
            ovf_labels.append(("join", (plan.key, i)))
    for pred in derived:
        ovf_labels.append(("delta", pred))
        ovf_labels.append(("tail", pred))
    join_caps = {id(plan): tuple(caps.join_cap(plan, i)
                                 for i in range(len(plan.joins)))
                 for plan, _ in active}
    delta_caps = {p: caps.delta_cap(p) for p in s_preds}
    n = len(s_preds)
    at = 2 * n                       # rounds, triggers, derived, iterations

    def step(consts, state):
        base = dict(zip(s_preds, consts[:n]))
        stores = dict(zip(o_preds, consts[n:]))
        w_datas, d_datas, scal = state[:n], state[n:2 * n], state[2 * n]
        tails = dict(zip(s_preds, w_datas))
        wcnt = dict(zip(s_preds, scal[:n].unbind()))
        deltas = dict(zip(s_preds, d_datas))

        def not_seen(rows, pred, cols=None):
            """keep-mask: rows whose tuple is in neither the phase-entry
            store nor the tail of ``pred``."""
            sel = rows if cols is None else ops.project_core(rows, cols)
            seen = (ops.member_mask_core(sel, base[pred])
                    | ops.member_mask_core(sel, tails[pred]))
            return (rows[:, 0] != pad_of(rows)) & ~seen

        triggers = torch.zeros((), dtype=torch.int64, device=scal.device)
        ovfs = []
        heads = {}
        for plan, jd in active:
            # linear tail: the only S-pred body atom is the delta
            inputs = [deltas[bp] if j == jd else stores[bp]
                      for j, bp in enumerate(plan.body_preds)]
            head, t, jovfs = _exec_rule_traced(
                plan, inputs, None, join_caps[id(plan)],
                prefilter=((lambda rows, cols, p=plan.head_pred:
                            not_seen(rows, p, cols))
                           if use_prefilter else None))
            triggers = triggers + t
            ovfs += jovfs
            heads.setdefault(plan.head_pred, []).append(head)
        new_w, new_wc, new_d, new_dc = [], [], [], []
        for pred in s_preds:
            if pred in heads:
                nw, nc, delta, nf, (od, ow) = _absorb_traced(
                    heads[pred], lambda rows, p=pred: not_seen(rows, p),
                    tails[pred], wcnt[pred], delta_caps[pred])
                ovfs += [od, ow]
            else:   # in S but not derived by any active rule: drains
                nw, nc = tails[pred], wcnt[pred]
                delta = torch.full_like(deltas[pred], pad_of(deltas[pred]))
                nf = torch.zeros((), dtype=torch.int64, device=scal.device)
            new_w.append(nw)
            new_wc.append(nc)
            new_d.append(delta)
            new_dc.append(nf)
        ovf = (torch.stack(ovfs) if ovfs
               else torch.zeros(0, dtype=torch.bool, device=scal.device))
        bad = ovf.any()
        good = (~bad).to(torch.int64)
        rounds, trg, drv, iters = scal[at:at + 4].unbind()
        tally = torch.stack([rounds + good, trg + good * triggers,
                             drv + good * sum(new_dc), iters + 1])
        counts = torch.where(bad, scal[:at], _bundle(new_wc + new_dc))
        return (*_select_state(bad, w_datas, new_w),
                *_select_state(bad, d_datas, new_d),
                torch.cat([counts, tally, ovf.to(torch.int64)]))

    def cond(scal):
        live = scal[n:2 * n].sum() > 0
        ok = ~(scal[at + 4:] != 0).any()
        return live & ok & (scal[at] < max_rounds)

    return step, cond, ovf_labels


def _fixpoint_program(s_preds, o_preds, caps, active, use_prefilter,
                      max_rounds, device):
    step, cond, labels = _build_fixpoint(s_preds, o_preds, caps, active,
                                         use_prefilter, max_rounds)
    loop = _DeviceLoop if device.type == "cuda" else _HostLoop
    return _Program(loop(step, cond), labels)


# ---------------------------------------------------------------------------
# materialize_fused's plan and program inputs (shared with
# lower_fused_programs, so a count runs at the shapes a run runs at)
# ---------------------------------------------------------------------------
def _rule_plans(kb):
    """Each rule's fused plan by ``id(rule)``; None when a rule lies outside
    the fused fragment."""
    plans = {}
    for rule in kb.program.rules:
        plan = compile_rule_plan(rule, kb.dict)
        if plan is None:
            return None
        plans[id(rule)] = plan
    return plans


def _plan_caps(kb, plans, stores, counts, lean: bool = False):
    """The capacity planner of a run that starts from ``stores`` holding
    ``counts`` rows; the memo keys it by the program and the facts the run
    starts from."""
    fp = program_fingerprint((plans[id(r)].key for r in kb.program.rules),
                             sum(counts.values()))
    return _Caps(fp, {p: (stores[p], counts[p]) for p in stores}, lean=lean)


def _active(plans, rules, live):
    """(plan, delta position) of every body atom over a live predicate."""
    return tuple((plans[id(r)], j) for r in rules
                 for j, a in enumerate(r.body) if a.pred in live)


def _round_args(preds, stores, counts, delta_preds, deltas, caps, dev):
    """A round program's inputs: the stores, their counts, and each live
    delta (pred -> (rows, count)) at its planned capacity."""
    return [*(stores[p] for p in preds),
            _upload([counts[p] for p in preds], dev),
            *(ops.fit_rows(deltas[p][0], caps.delta_cap(p))
              for p in delta_preds)]


def _fixpoint_inputs(kb, caps, s_preds, o_preds, stores, deltas, rounds,
                     n_ovf, dev):
    """A fixpoint program's constants (the stores) and initial state:
    empty tails, the live deltas (pred -> (rows, count)) at their planned
    capacities, PAD blocks where none is live, and the scalars (tail
    counts, delta counts, rounds, triggers, derived, iterations, one flag
    per overflow label).  Returns (consts, state, delta counts)."""
    def pad_block(rows, p):
        return torch.full((rows, kb.arities[p]), kb.rels[p].pad,
                          dtype=stores[p].dtype, device=dev)

    n = len(s_preds)
    dcounts = [deltas[p][1] if p in deltas else 0 for p in s_preds]
    consts = [stores[p] for p in s_preds + o_preds]
    state = [*(pad_block(caps.tail_cap(p), p) for p in s_preds),
             *(ops.fit_rows(deltas[p][0], caps.delta_cap(p))
               if p in deltas else pad_block(caps.delta_cap(p), p)
               for p in s_preds),
             _upload([0] * n + dcounts + [rounds, 0, 0, 0] + [0] * n_ovf,
                     dev)]
    return consts, state, dcounts


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
def materialize_fused(kb, mode: str = "tg", max_rounds: int = 10_000,
                      initial_deltas=None, spill: bool = True):
    """Fused-program materialization of ``kb``.  Returns MatStats, or None
    when the program is outside the fused fragment (the caller falls back to
    the two-phase executor).

    ``initial_deltas`` (pred -> lexsorted Relation of rows ALREADY absorbed
    into the store) switches the driver to incremental mode: round 1 over
    the extensional rules is skipped and the seeded deltas enter the
    semi-naive loop directly — the entry point behind
    ``repro_torch.engine.incremental.materialize_delta``.  Seeded deltas may
    live on EDB predicates, so the loop considers every rule with a live
    body atom.

    Capacity overflows retry under a ``RetryBudget``
    (``REPRO_MAX_RETRIES`` / ``REPRO_MAX_RESIDENT_MB``); when the budget is
    exhausted mid-run the driver writes its last-good state back and
    ``spill``s the remaining rounds to the two-phase executor (``spill=
    False`` re-raises the ``CapacityError``).

    With ``REPRO_CKPT_DIR`` set, the driver checkpoints at every host
    pull boundary (post-ext round, every host-stepped round, every
    fixpoint exit) and resumes from the newest valid checkpoint —
    including checkpoints written by the two-phase executor."""
    from repro_torch.engine.materialize import MatStats
    program = kb.program
    plans = _rule_plans(kb)
    if plans is None:
        return None

    preds = tuple(sorted(kb.rels))
    use_prefilter = mode == "tg"
    dev = kb.device
    # what a built program is specialised to beside its capacities
    layout = (dev.type, str(kb.dict.id_dtype),
              tuple(kb.arities[p] for p in preds))
    st = MatStats(mode=mode)
    st.extra["fused"] = True

    # delta-mode lifecycles belong to the caller: no checkpointing there
    ck = recovery.EngineCheckpointer(kb, mode, "fused",
                                     enabled=initial_deltas is None)
    resume = ck.maybe_resume(st)    # replaces kb.dict / kb.rels on success

    # fused precondition: lexsorted, set-semantic stores
    stores, counts = {}, {}
    for p in preds:
        rel = kb.rels[p]
        if rel.count and not rel.is_lexsorted:
            rel = ops.dedup(rel)
        stores[p], counts[p] = rel.data, rel.count
    caps = _plan_caps(kb, plans, stores, counts,
                      lean=initial_deltas is not None)
    if ck.caps_state is not None:
        caps.adopt(ck.caps_state)   # converged plan from the checkpoint
    for p in preds:
        stores[p] = ops.fit_rows(stores[p], caps.store[p])

    row_bytes = max((kb.rels[p].dtype.itemsize * kb.arities[p]
                     for p in preds), default=8)
    budget = RetryBudget(caps, row_bytes=row_bytes)

    ext_plans = [plans[id(r)] for r in program.extensional_rules()]
    loop_rules = list(program.rules)
    loop_plans = [plans[id(r)] for r in loop_rules]
    deltas: dict = {}           # pred -> (data at planner delta cap, count)
    progressed = resume is not None

    def state_fn():
        """Host-consistent checkpoint payload (single shard): trimmed
        stores, live deltas, and the base facts."""
        payload = {}
        for p in preds:
            payload[f"store__{p}"] = stores[p][:counts[p]].cpu().numpy()
        for p, (d, c) in deltas.items():
            rows = d[:c].cpu().numpy()
            payload[f"delta__{p}"] = rows[host_order(rows)]
        for p, rel in kb.base.items():
            payload[f"base__{p}"] = rel.np_rows()
        return [payload]

    def run_round(active, delta_preds, is_ext=False):
        nonlocal stores, counts
        prefilter = use_prefilter and not is_ext   # no Def. 23 in round 1
        n = len(preds)
        while True:
            sig = _round_signature(preds, caps, active, delta_preds,
                                   prefilter, layout)
            prog = _cached_program(sig, lambda: _round_program(
                preds, caps, active, delta_preds, prefilter, dev))
            args = _round_args(preds, stores, counts, delta_preds, deltas,
                               caps, dev)
            outs = prog.run(*args)
            vals = _pull(outs[-1])
            k = len(prog.derived)
            cnts, dcnts, trg = vals[:n], vals[n:n + k], vals[n + k]
            ovf = vals[n + k + 1:]
            if not any(ovf):
                budget.ok()
                stores = dict(zip(preds, outs[:n]))
                counts = dict(zip(preds, cnts))
                st.triggers += trg
                new = {}
                for p, d, c in zip(prog.derived, outs[n:n + k], dcnts):
                    st.derived += c
                    if c:
                        new[p] = (d, c)
                return new
            ops.HOST_SYNC_STATS.fused_retries += 1
            # the failed replay overwrote the outputs the driver may still
            # point at; the inputs it was given are intact
            held = prog.run.held(args)
            stores = dict(zip(preds, held[:n]))
            for p, d in zip(delta_preds, held[n + 1:]):
                deltas[p] = (d, deltas[p][1])
            _drop_program(sig)           # superseded by the doubled plan
            # a rule active at several delta positions repeats its join
            # labels; dedupe so a shared capacity doubles once per retry
            budget.overflow(dict.fromkeys(
                l for f, l in zip(ovf, prog.labels) if f))
            for p in preds:
                stores[p] = ops.fit_rows(stores[p], caps.store[p])

    def run_fixpoint(s_preds, active):
        """The linear tail: loop launches until an exit without overflow.
        Returns nothing; sets ``deltas`` to {} when the phase is done."""
        nonlocal deltas, progressed
        o_preds = tuple(p for p in preds if p not in s_preds)
        n = len(s_preds)
        while True:
            sig = _fix_signature(s_preds, o_preds, caps, active,
                                 use_prefilter, max_rounds, layout)
            prog = _cached_program(sig, lambda: _fixpoint_program(
                s_preds, o_preds, caps, active, use_prefilter, max_rounds,
                dev))
            consts, state, dcounts = _fixpoint_inputs(
                kb, caps, s_preds, o_preds, stores, deltas, st.rounds,
                len(prog.labels), dev)
            enter = sum(dcounts) > 0 and st.rounds < max_rounds
            out = prog.run(consts, state, enter)
            vals = _pull(out[-1])
            wcnts, dcnts = vals[:n], vals[n:2 * n]
            rounds, trg, drv, iters = vals[2 * n:2 * n + 4]
            ovf = vals[2 * n + 4:]
            prog.run.count(iters)
            prev_rounds = st.rounds
            st.rounds = rounds
            st.triggers += trg
            st.derived += drv
            deltas = {p: (d, c) for p, d, c in
                      zip(s_preds, out[n:2 * n], dcnts) if c}
            # fold tails into the stores (exits are rare: done, a full
            # tail, or a capacity retry)
            for p, d, c in zip(s_preds, out[:n], wcnts):
                if c:
                    ar = kb.arities[p]
                    merged = ops.merge_union(
                        Relation(stores[p], counts[p], lex_order(ar)),
                        Relation(d, c, lex_order(ar)))
                    counts[p] = merged.count
                    caps.store[p] = max(caps.store[p], merged.capacity)
                    stores[p] = ops.fit_rows(merged.data, caps.store[p])
                    if stores[p].data_ptr() == d.data_ptr():
                        # an empty store "merged" into the tail buffer,
                        # which the next launch overwrites
                        stores[p] = _own(stores[p])
            if st.rounds > prev_rounds:
                budget.ok()     # the loop advanced: real progress
                progressed = True
            ck.boundary(st, state_fn, caps=caps)
            if not any(ovf):
                deltas = {}
                return
            to_double = []
            for flag, label in zip(ovf, prog.labels):
                if not flag:
                    continue
                if label[0] == "tail" and wcnts[s_preds.index(label[1])]:
                    # tail-full exit: the fold above made room; double
                    # only when even an empty tail cannot hold one round's
                    # fresh rows
                    continue
                to_double.append(label)
            if to_double:
                ops.HOST_SYNC_STATS.fused_retries += 1
                _drop_program(sig)       # superseded by the doubled plan
                budget.overflow(dict.fromkeys(to_double))

    def drive():
        nonlocal deltas, progressed
        if resume is not None:
            st.extra["resumed"] = True
            for p, rows in resume.items():
                caps.seed_delta(p, len(rows))
                rel = kb._relation(rows, sorted_by=lex_order(rows.shape[1]))
                deltas[p] = (ops.fit_rows(rel.data, caps.delta_cap(p)),
                             len(rows))
        elif initial_deltas is None:
            # round 1: extensional rules over B
            ext_active = tuple((plan, None) for plan in ext_plans)
            if ext_active:
                deltas = run_round(ext_active, (), is_ext=True)
            st.rounds = 1
            progressed = True
            ck.boundary(st, state_fn, caps=caps)
        else:
            st.extra["delta"] = True
            for p, rel in initial_deltas.items():
                if rel.count:
                    caps.seed_delta(p, rel.count)
                    deltas[p] = (rel.data, rel.count)

        # fixpoint rounds
        while deltas and st.rounds < max_rounds:
            live = tuple(sorted(deltas))
            tail = _linear_tail(loop_plans, live)
            if tail is not None:
                run_fixpoint(*tail)
                break
            active = _active(plans, loop_rules, deltas)
            if not active:
                break
            deltas = run_round(active, live)
            st.rounds += 1
            progressed = True
            ck.boundary(st, state_fn, caps=caps)

    try:
        drive()
    except CapacityError as e:
        if not spill:
            raise
        if not progressed:
            return None     # cold-start overflow: plain fragment fallback
        # graceful degradation: write the last-good state back and run the
        # remaining rounds on the two-phase executor, whose buffers grow
        # incrementally instead of by whole-plan doubling
        from repro_torch.engine.materialize import _fixpoint_rounds
        for p in preds:
            kb.rels[p] = Relation(_own(stores[p]), counts[p],
                                  lex_order(kb.rels[p].arity))
        seed = {}
        for p, (d, c) in deltas.items():
            rows = d[:c].cpu().numpy()
            seed[p] = kb._relation(rows[host_order(rows)],
                                   sorted_by=lex_order(kb.arities[p]))
        st.extra["spilled"] = str(e)
        _fixpoint_rounds(kb, st, seed, mode, max_rounds, ck)
        return st

    for p in preds:
        kb.rels[p] = Relation(_own(stores[p]), counts[p],
                              lex_order(kb.rels[p].arity))
    caps.memoize()
    ck.final(st, state_fn, caps=caps)
    return st


# ---------------------------------------------------------------------------
# program counts for the roofline analysis (nothing captured or committed)
# ---------------------------------------------------------------------------
# the trip count at which a fixpoint program is counted: the reference's
# HLO walk reads a while loop's trip count from a scalar constant in its
# condition (``hlo_analysis._trip_count``), and the fixpoint's condition
# holds none (its round limit is a loop-carried scalar), so the walk takes
# its default, one iteration
FIXPOINT_TRIPS = 1


def _probe_deltas(kb, preds, caps):
    """Live deltas at the planner's capacities, for counting: each holds
    the first rows of its predicate's store (real facts, lexsorted), PAD
    after them.  pred -> (rows, count)."""
    out = {}
    for p in preds:
        rel = kb.rels[p]
        cap = caps.delta_cap(p)
        n = min(rel.count, cap)
        out[p] = (ops.fit_rows(rel.data[:n], cap).clone(), n)
    return out


def lower_fused_programs(kb, mode: str = "tg"):
    """Count (without capturing and without committing) the fused
    executor's programs for ``kb`` at the capacity planner's current
    shapes: ``{name: record}`` (``repro_torch.analysis.cost``'s record,
    with ``sort_ops_static`` and ``trip_count``) for the steady-state round
    program and, when the program has a linear tail, the fixpoint program.

    Call it AFTER a real materialization, so the capacity memo holds the
    converged buckets and the planner reproduces the shapes the timed run
    ran at.  Each program runs once as plain torch ops on the KB's device,
    on copies: the stores at their planned capacities, each live delta the
    first rows of its store.  Its outputs and overflow flags are dropped:
    no retry, no memo update, no graph.  A fixpoint program counts one
    iteration (``FIXPOINT_TRIPS``, the trip count the reference's walk
    takes for it).  ``sort_ops_static`` is the number of sort calls in one
    program body.  Returns None outside the fused fragment, ``{}`` when no
    rule reads a derived predicate."""
    from repro_torch.analysis import cost
    plans = _rule_plans(kb)
    if plans is None:
        return None
    rules = kb.program.rules
    preds = tuple(sorted(kb.rels))
    use_prefilter = mode == "tg"
    dev = kb.device
    # materialize_fused's plan: a run of a KB starts from its base facts (the
    # reference keys by the materialized count, whose pow-2 bucket is
    # usually another, and then plans from cold guesses)
    caps = _plan_caps(kb, plans, {p: kb.base[p].data for p in preds},
                      {p: kb.base[p].count for p in preds})
    loop_plans = [plans[id(r)] for r in rules]
    derived = {pl.head_pred for pl in loop_plans}
    active = _active(plans, rules, derived)
    if not active:
        return {}

    def counted(fn, *args, trips=1):
        with cost.Recorder() as r:
            fn(*args)
        total = cost.Cost()
        total.add(r.cost, trips)
        rec = total.as_dict()
        rec["sort_ops_static"] = r.cost.sorts
        rec["trip_count"] = trips
        return rec

    def stores():
        return {p: ops.fit_rows(kb.rels[p].data, caps.store[p]).clone()
                for p in preds}

    out = {}
    delta_in = tuple(sorted({plan.body_preds[jd] for plan, jd in active}))
    fn, _, _ = _build_round(preds, caps, active, delta_in, use_prefilter)
    out["round"] = counted(fn, *_round_args(
        preds, stores(), {p: kb.rels[p].count for p in preds}, delta_in,
        _probe_deltas(kb, delta_in, caps), caps, dev))
    # the fixpoint's steady-state live set is usually smaller than the
    # early-round one (aux predicates quiesce): fall back to singleton live
    # sets, as the reference does
    tail = _linear_tail(loop_plans, delta_in)
    if tail is None:
        for p in sorted(derived):
            tail = _linear_tail(loop_plans, (p,))
            if tail is not None:
                break
    if tail is not None:
        s_preds, t_active = tail
        o_preds = tuple(p for p in preds if p not in s_preds)
        step, cond, labels = _build_fixpoint(s_preds, o_preds, caps,
                                             t_active, use_prefilter, 10_000)
        consts, state, _ = _fixpoint_inputs(
            kb, caps, s_preds, o_preds, stores(),
            _probe_deltas(kb, s_preds, caps), 0, len(labels), dev)

        def iteration():
            new = step(consts, state)
            cond(new[-1])

        out["fixpoint"] = counted(iteration, trips=FIXPOINT_TRIPS)
    return out
