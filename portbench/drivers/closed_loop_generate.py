"""Closed-loop generation: a fixed number of clients, each submitting its
next prompt to the port's GenerationService when its reply arrives.

Traffic parameters: `slots`, `kv_dtype` (the service's), `clients`,
`prompt_min` / `prompt_max` (prompt lengths, each length of the range
equally often, in an order drawn from the seed), `bucket` (the prefill
width they fall in: the service's smallest of 64, 256, 1024 and the
window that holds `prompt_max`), `max_new`,
`warmup_completions` (replies before the window opens, the closed loop
filled), `check_requests` (replies of the window compared with the
reference, drawn from the seed, the longest prompt among them),
`drain_s` (the wait for the replies still out when the window closes).
Requests are greedy. Every seed sends the same multiset of lengths.

Each request is timed from the client's side, from just before `submit`
to its reply. The window's requests are those whose reply arrived in it.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import harness, models, trace, weights, yardstick


def _build(run):
    from simpleinfer_tpu_torch import Engine, EngineConfig, zoo
    from simpleinfer_tpu_torch.serving import GenerationService

    cfg, tr = run.config, run.traffic
    graph, _, _ = zoo.build_gpt(
        "small", seq_len=cfg["n_positions"], vocab_size=cfg["vocab_size"],
        depth=cfg["n_layer"], width=cfg["n_embd"], num_heads=cfg["n_head"])
    made = weights.fill_graph(graph, run.seed, run.device)
    made = _as_published(graph, made, cfg)
    eng = Engine(EngineConfig(compute_dtype=cfg["compute_dtype"],
                              quant=cfg["quant"],
                              int4_group=cfg["int4_group"],
                              device=run.device))
    eng.load_model(None, graph=graph)
    svc = GenerationService(eng, slots=tr["slots"], kv_dtype=tr["kv_dtype"])
    return eng, svc, made


def _as_published(graph, made, cfg):
    """Set what the builder does not take from the published config: the
    GELU's form, the norms' epsilon, and the head tied to the token
    embedding (its weight the embedding's values). Returns `made` with
    the head's entry made the embedding's."""
    from simpleinfer_tpu_torch.ir.graph import Attribute, Parameter

    approx = {"gelu_new": "tanh", "gelu": "none"}[cfg["activation_function"]]
    for op in graph.ops:
        if op.type == "nn.GELU":
            op.params["approximate"] = Parameter.from_value(approx)
        elif op.type == "nn.LayerNorm":
            op.params["eps"] = Parameter.from_value(
                float(cfg["layer_norm_epsilon"]))
    if not cfg["tie_word_embeddings"]:
        return made
    wte = next(a for _, t, _, a in made if t == "nn.Embedding")
    head = [i for i, m in enumerate(made) if m[1] == "nn.Linear"][-1]
    name, op_type, key, arr = made[head]
    if arr.shape != wte.shape:
        raise ValueError(f"head {arr.shape} cannot tie to {wte.shape}")
    graph_op = next(op for op in graph.ops if op.name == name)
    graph_op.attrs[key] = Attribute.from_array(wte.copy())
    return made[:head] + [(name, op_type, key, wte)] + made[head + 1:]


class _Clients:
    """The closed loop. Request j (in submission order) has the j-th
    length of the seed's schedule and ids from the seed's token pool."""

    def __init__(self, run, svc):
        tr, cfg = run.traffic, run.config
        self.svc, self.max_new = svc, tr["max_new"]
        rng = np.random.default_rng(run.seed)
        lens = np.arange(tr["prompt_min"], tr["prompt_max"] + 1)
        self.lens = rng.permutation(np.tile(lens, -(-4096 // len(lens))))
        self.pool = rng.integers(0, cfg["vocab_size"], 1 << 20)
        self.lock = threading.Lock()
        self.stopping = False
        self.n = 0
        self.out = 0
        self.idle = threading.Condition(self.lock)
        # per request: (prompt, t_submit, t_reply, served token or None)
        self.reqs: list = []
        self.errors: list = []

    def prompt(self, j: int) -> np.ndarray:
        n = int(self.lens[j % len(self.lens)])
        at = (j * 7919) % (len(self.pool) - n)
        return self.pool[at:at + n]

    def submit(self) -> None:
        with self.lock:
            if self.stopping:
                return
            j = self.n
            self.n += 1
            self.out += 1
            rec = [self.prompt(j), 0.0, None, None]
            self.reqs.append(rec)
        rec[1] = time.perf_counter()
        fut = self.svc.submit(rec[0], self.max_new)
        fut.add_done_callback(lambda f, rec=rec: self.reply(f, rec))

    def reply(self, fut, rec) -> None:
        rec[2] = time.perf_counter()
        try:
            rec[3] = int(fut.result()[-1])
        except Exception as e:  # noqa: BLE001 (a failed request counts)
            self.errors.append(repr(e))
        with self.lock:
            self.out -= 1
            self.idle.notify_all()
        self.submit()

    def done(self) -> int:
        with self.lock:
            return sum(1 for r in self.reqs if r[2] is not None)

    def drain(self, timeout: float) -> bool:
        with self.lock:
            self.stopping = True
            return self.idle.wait_for(lambda: self.out == 0, timeout)


def _stats(svc) -> dict:
    s = svc.stats
    return {"prefills": s.prefills, "steps": s.steps}


def run(run):
    tr, cfg = run.traffic, run.config
    eng, svc, made = _build(run)
    harness.log(run, "engine loaded")
    svc.start()
    clients = _Clients(run, svc)
    try:
        for _ in range(tr["clients"]):
            clients.submit()
        # set-up ends once the loop is full and every shape it runs ran
        while clients.done() < tr["warmup_completions"]:
            if clients.errors:
                raise RuntimeError(f"a request failed: {clients.errors[0]}")
            time.sleep(0.005)
        run.window_opens()
        harness.log(run, "window opens")
        cap = None
        for _ in range(trace.CAPTURES if run.trace else 1):
            with trace.profiled(run.trace) as prof:
                launched = trace.hand_launches()
                s0 = _stats(svc)
                with trace.span("window", run.trace):
                    t0 = time.perf_counter()
                    time.sleep(run.seconds)
                    t1 = time.perf_counter()
                s1 = _stats(svc)
                launched = trace.hand_launches() - launched
            if prof is None:
                break
            cap = trace.Capture(prof, launched)
            harness.log(run, f"capture read: {cap.recorded} of "
                        f"{cap.launched} launches of the port's kernels "
                        f"recorded")
            if cap.complete:
                break
        drained = clients.drain(tr["drain_s"])
    finally:
        svc.stop(drain=False)
    if not drained:
        raise RuntimeError(f"requests still out {tr['drain_s']} s after "
                           f"the window closed")
    win = [r for r in clients.reqs if r[2] is not None and t0 <= r[2] <= t1]
    ttft = np.array([r[2] - r[1] for r in win]) * 1e3
    run.attempted = len(win)
    run.failed = sum(1 for r in win if r[3] is None)
    run.end_to_end["ttft_p95_ms"] = float(np.percentile(ttft, 95))
    run.end_to_end["prompt_tok_per_s"] = \
        sum(len(r[0]) for r in win) / (t1 - t0)
    run.end_to_end["setup_s"] = run.setup_s
    waves = s1["steps"] - s0["steps"]
    run.ctx.update(waves=waves, rows=s1["prefills"] - s0["prefills"],
                   window_ms=(t1 - t0) * 1e3)
    if run.trace:
        _trace_ctx(run, cap, win, t0)
    run.window_closed()
    harness.log(run, "window closed; the reference runs")

    # correctness: each sampled reply's token against the reference's
    # logits at the prompt's last position
    del svc, eng
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    served = [r for r in win if r[3] is not None]
    rng = np.random.default_rng(run.seed + 2)
    n = min(tr["check_requests"], len(served))
    pick = set(int(i) for i in rng.choice(len(served), n, replace=False))
    pick.add(int(np.argmax([len(r[0]) for r in served])))
    sample = [served[i] for i in sorted(pick)]
    w = models.gpt2_weights(models.gpt2_raw(made, cfg, run.device), cfg,
                            cfg["int4_group"])
    logits = models.gpt2_reference(w, cfg, [r[0] for r in sample])
    tok = torch.tensor([r[3] for r in sample], device=logits.device)
    gap = logits.max(-1).values - logits.gather(1, tok[:, None])[:, 0]
    run.checks["logit_gap"] = (float(gap.max()),
                               cfg["limits"]["logit_gap"])
    run.checks["failed"] = (float(len(clients.errors)), 0.0)


def _trace_ctx(run, cap, win, t0):
    cfg, tr = run.config, run.traffic
    in_trace = [r for r in win if r[2] - t0 <= cap.window_s]
    run.busy_s, run.window_s = cap.busy_s, cap.window_s
    run.breakdown = {"device_ops": cap.device_ops(10),
                     "idle_gaps": cap.idle_gaps(10, "service")}
    width = tr["bucket"]
    wave = yardstick.int4w_calls_wave(cfg, tr["slots"], width,
                                      cfg["int4_group"])
    step = yardstick.int4w_calls_decode(cfg, tr["slots"], cfg["int4_group"])
    run.ctx.update(
        capture=cap,
        model_flops=sum(yardstick.gpt2_flops(cfg, len(r[0]))
                        for r in in_trace),
        int4w_calls_per_wave=len(wave) + len(step),
        int4w_min_s_per_wave=yardstick.min_seconds(wave + step),
        flash_min_s_per_call=yardstick.min_seconds(
            yardstick.flash_calls_wave(cfg, tr["slots"], width)[:1]))
