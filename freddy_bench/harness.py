"""One run of one cell: data and indexes from the seed, the server, the
client fleet, warm-up, the measured window, the metrics and the
comparison with the reference, then one JSON line.

The order of a run (``run``):

1. the client process starts (it boots while the card works) and takes
   the last core the run may use; this process keeps the others;
2. the vectors are drawn on the card from the seed, the configuration's
   indexes are built, and with ``--trace 1`` the profiler starts;
3. ``AsyncQueryServer`` starts in this process and the cell's set-up
   requests go through its HTTP front end (``/config``, target sets,
   statistics);
4. the cell's batch shapes are warmed, then the clients run a warm-up
   window of their own words;
5. the window: every client connection sends for ``--seconds``;
   ``setup_s`` is the process's age when it opens;
6. the metrics are read, the peak memory too, the server and the fleet
   stop, the program's state is freed, and the sampled answers are held
   to the plain reference.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
import types
import urllib.request

from freddy_bench import check, manifest
from freddy_bench.traffic.fleet import ClientFleet, child_processes

#: top-level module names that must not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "postgres_word2vec_tpu")
#: rows sampled for the check of the index build
BUILD_SAMPLE = 4096
#: how long a client may wait for one answer before it counts as failed
ANSWER_TIMEOUT_S = 60.0


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rpartition(")")[2].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def thread_times() -> dict:
    """Each thread of this process's CPU time (name → user + system), in
    clock ticks. (The host's own counters are not read: in a sandbox such
    as gVisor ``/proc/stat`` reads zeros.)"""
    threads: dict = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                name, _, rest = f.read().rpartition(")")
        except OSError:
            continue
        fields = rest.split()
        key = f"{name.partition('(')[2]}/{tid}"
        threads[key] = int(fields[11]) + int(fields[12])
    return threads


def print_window_diagnostics(reports: list, th0: dict, th1: dict) -> None:
    """On standard error: answers completed in each second of the window,
    and the CPU seconds of this process's busiest threads over it, so that
    a run that reads far off can be traced to the window's time."""
    per = [0] * max(len(r["per_second"]) for r in reports)
    for r in reports:
        for i, v in enumerate(r["per_second"]):
            per[i] += v
    hz = os.sysconf("SC_CLK_TCK")
    busy = sorted(((v - th0.get(k, 0)) / hz, k)
                  for k, v in th1.items())[::-1][:8]
    print(f"window: answers a second {per}; this process's busiest "
          f"threads (cpu s) {[(k, round(v, 2)) for v, k in busy]}",
          file=sys.stderr, flush=True)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is one of
    :data:`FORBIDDEN_MODULES`, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def post(port: int, path: str, payload, timeout: float = 600.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def seed64(seed: int) -> int:
    """The run's seed as a non-negative 64-bit integer."""
    return seed % (1 << 64)


def build_engine(cfg: dict, vecs, seed: int):
    """The configuration's engine over ``vecs`` (rows already normalized),
    words ``w0 … w{n-1}``."""
    from postgres_word2vec_tpu_torch import ExactIndex, Freddy, VectorStore

    store = VectorStore.from_arrays([f"w{i}" for i in range(vecs.shape[0])],
                                    vecs, normalized=True)
    eng = Freddy.build(store, seed=seed, **cfg["build"])
    ex = cfg.get("exact")
    if ex is not None:
        eng.exact = ExactIndex(store.vectors_norm, ex["dtype"],
                               approx=ex.get("fused", False),
                               fused=ex.get("fused", False))
    return eng


def snapshot(srv) -> dict:
    """The program's counters and spans at one instant: the runner's
    stage seconds, the micro-batchers' counters, the tracker's lists'
    lengths."""
    from postgres_word2vec_tpu_torch.utils.tracker import GLOBAL_TRACKER

    h = srv._health()
    return {"stage_s": dict(srv.runner.stage_s),
            "batcher": {key: v for key, v in h.items()
                        if key.endswith(("_batched_calls", "_items_done"))},
            "tracker": {key: len(v) for key, v
                        in GLOBAL_TRACKER.get_results().items()}}


def window_counters(before: dict, after: dict) -> dict:
    """What the program counted inside the window."""
    from postgres_word2vec_tpu_torch.utils.tracker import GLOBAL_TRACKER

    res = GLOBAL_TRACKER.get_results()
    return {"stage_s": {key: after["stage_s"][key] - before["stage_s"][key]
                        for key in after["stage_s"]},
            "batcher": {key: after["batcher"][key] - before["batcher"][key]
                        for key in after["batcher"]},
            "tracker": {key: res[key][before["tracker"].get(key, 0):
                                      after["tracker"][key]]
                        for key in after["tracker"]}}


def make_targets(spec: dict, n: int, seed: int, device):
    """A cell's target set: ``size`` rows drawn from the seed without
    repetition (sorted), or every row for "all"."""
    import torch

    if spec["size"] == "all" or int(spec["size"]) >= n:
        return torch.arange(n, device=device)
    g = torch.Generator(device=device).manual_seed(seed64(seed) ^ 0x7461)
    pick = torch.randperm(n, generator=g, device=device)[:int(spec["size"])]
    return torch.sort(pick).values


def ivf_state(eng) -> dict:
    """The program's IVFADC tables that the reference follows, copied out
    before the engine is freed: coarse centroids, residual codebook, each
    row's cell and codes in row order."""
    ivf = eng.ivfadc
    codes = ivf.codes_sorted.new_empty(ivf.codes_sorted.shape)
    codes[ivf.row_ids.long()] = ivf.codes_sorted
    return {"coarse": ivf.coarse.centroids.clone(),
            "codebook": ivf.codebook.centroids.clone(),
            "assign": ivf.assignments.clone(), "codes": codes}


def control_answers(kind: str, control: str, vectors, qids, k: int, *,
                    ivf=None, pvf: int = 20, w: int = 3, targets=None):
    """The control's answers for the sampled query rows: the reference in
    the precision below the configuration's, in the program's place."""
    import torch

    from freddy_bench.reference import lowp

    if kind == "ivfadc_pv":
        ids, sims = lowp.ivfadc_pv(ivf, qids, k, pvf, w)
    else:
        ids, sims = lowp.top_k(vectors, qids, k, control,
                               targets=targets)
    bad = torch.zeros(qids.shape[0], dtype=torch.bool, device=qids.device)
    return qids, ids, sims, bad


def run(cell: str, seed: int, seconds: float, trace: bool, *,
        device: str | None = None, overrides: dict | None = None,
        control: bool = False) -> dict:
    """One run of ``cell`` → the result line's object. ``device`` (tests
    only) runs it on another device than the card; ``overrides`` replaces
    keys of the configuration and the cell (tests shrink them);
    ``control`` adds the control's numbers under ``control``."""
    overrides = overrides or {}
    bench = manifest.load_benchmark()
    entry = manifest.workload_entry(bench, cell)
    wl = {**manifest.load_json("workloads", cell),
          **overrides.get("workload", {})}
    cfg = {**manifest.load_json("configs", wl["config"]),
           **overrides.get("config", {})}
    metrics = manifest.cell_metrics(bench, cell, trace)

    fleet = ClientFleet(int(wl["clients"]))
    # the client process takes the last core; this process (the server
    # and the program) the others, so the two do not compete for a core
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 4:
        os.sched_setaffinity(0, set(cores[:-1]))
    srv = tracer = None
    stopped = False
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                raise SystemExit("freddy_bench: no CUDA device")
            if torch.cuda.device_count() < int(entry["chips"]):
                raise SystemExit(f"freddy_bench: {entry['chips']} cards "
                                 f"asked, {torch.cuda.device_count()} seen")
            device = "cuda"
        dev = torch.device(device)
        from freddy_bench.traffic import synth
        from postgres_word2vec_tpu_torch.server_async import AsyncQueryServer

        n, d = int(cfg["rows"]), int(cfg["dim"])
        gen = torch.Generator(device=dev).manual_seed(seed64(seed))
        vecs = synth.generate_wordlike(gen, n, d)
        eng = build_engine(cfg, vecs, seed64(seed) % (1 << 62))
        if trace and dev.type == "cuda":
            from freddy_bench.trace import DeviceTrace

            tracer = DeviceTrace()
            tracer.start()
        srv = AsyncQueryServer(eng, port=0, **cfg["front_end"]).start()
        targets = None
        if "targets" in wl:
            t = wl["targets"]
            targets = make_targets(t, n, seed, dev)
            tl = targets.tolist()
            post(srv.port, "/prepare_targets", {"name": t["name"],
                                                "targets": tl})
            if t.get("statistics"):
                post(srv.port, "/statistics", {
                    "name": t["name"], "domain": [f"w{i}" for i in tl]})
        for step in wl["setup"]:
            post(srv.port, step["path"], step["body"])
        k = int(wl["body"]["k"])
        if wl["endpoint"] == "/knn":
            srv.warmup(k=k)
        spec = dict(port=srv.port, path=wl["endpoint"], n=n,
                    query_words=int(wl["query_words"]), body=wl["body"],
                    seed=seed64(seed), timeout_s=ANSWER_TIMEOUT_S)
        fleet.open(float(wl["warm_seconds"]), phase=1, sample_p=0.0,
                   keep_ids=False, **spec)
        warm = fleet.collect()
        warm_err = sum(r["errors"] for r in warm)
        if warm_err:
            kinds = [r["error_kinds"] for r in warm if r["errors"]]
            raise RuntimeError(f"warm-up failed {warm_err} requests: "
                               f"{kinds[:2]}")
        # every run opens its window with set-up's garbage collected, so a
        # full collection of it does not fall into some windows only
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize()

        # ---- the measured window
        before = snapshot(srv)
        th0 = thread_times()
        fleet.open(seconds, phase=2, sample_p=float(wl["sample_p"]),
                   keep_ids=trace, **spec)
        t_open = time.perf_counter()
        setup_s = process_age_s()
        if tracer is not None:
            tracer.open()
        time.sleep(max(0.0, t_open + seconds - time.perf_counter()))
        after = snapshot(srv)
        if tracer is not None:
            tracer.close()
        th1 = thread_times()
        reports = fleet.collect()
        print_window_diagnostics(reports, th0, th1)
        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
            kind_name = torch.cuda.get_device_name(dev)
        else:
            peak, kind_name = 0, str(dev)
        if tracer is not None:
            tracer.stop()
            stopped = True

        lat = [x for r in reports for x in r["lat"]]
        ctx = types.SimpleNamespace(
            cell=cell, workload=wl, config=cfg, seconds=seconds,
            setup_s=setup_s, latencies=lat,
            completed=sum(r["in_window"] for r in reports),
            sent_ids=[i for r in reports for i in r["sent_ids"]],
            counters=window_counters(before, after),
            trace=None if tracer is None else tracer.data, engine=eng)
        values = {}
        for m in metrics:
            v = manifest.metric_reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        samples = [s for r in reports for s in r["samples"]]
        attempted = len(lat)
        failed = sum(1 for x in lat if x is None)

        srv.stop()
        srv = None
        fleet.close()
        left = child_processes()
        if left:
            raise RuntimeError(f"processes left running: {left[:4]}")

        # ---- the program's state is freed; the reference runs
        ref = wl["check"]
        pvf, w = 20, 3
        for step in wl["setup"]:
            pvf = int(step["body"].get("set_pvf", pvf))
            w = int(step["body"].get("set_w", w))
        ivf_tables = ivf_state(eng) if ref["reference"] == "ivfadc_pv" \
            else None
        del eng, ctx
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers = {}
        ivf = None
        if ivf_tables is not None:
            from freddy_bench.reference.ivfadc import (IVFADCReference,
                                                       build_misses)

            g = torch.Generator(device=dev).manual_seed(seed64(seed) ^ 0xB1D)
            rows = torch.randint(0, n, (BUILD_SAMPLE,), generator=g,
                                 device=dev)
            numbers["build_miss"] = build_misses(vecs, rows, **ivf_tables)
            ivf = IVFADCReference(vecs, **ivf_tables)
        parsed = check.parse(samples, k, n, wl["endpoint"] == "/knn_join")
        answers = check.as_tensors(*parsed, dev)
        numbers.update(check.compare(ref["reference"], answers, vecs, k,
                                     ivf=ivf, pvf=pvf, w=w, targets=targets))
        limits = check.limits_of(ref)
        ok, pairs = check.judge(numbers, limits)
        result = {
            "correct": bool(ok and failed == 0 and attempted > 0
                            and numbers["rows_checked"] > 0),
            "attempted": attempted, "failed": failed, "metrics": values,
            "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                       "kind": kind_name, "count": int(entry["chips"]),
                       "memory_peak_bytes": int(peak)}}
        if tracer is not None and tracer.data is not None:
            result["device"]["busy_s"] = tracer.data.busy_s
            result["device"]["window_s"] = tracer.data.window_s
            result["breakdown"] = tracer.data.breakdown()
        result["checks"] = dict(
            pairs, rows_checked={"value": numbers["rows_checked"],
                                 "limit": "> 0"},
            failed={"value": failed, "limit": 0})
        if control:
            cans = control_answers(ref["reference"], ref["control"], vecs,
                                   answers[0], k, ivf=ivf, pvf=pvf, w=w,
                                   targets=targets)
            # the control stands in for the search, after the build
            result["control"] = {
                **{key: numbers[key] for key in ("build_miss",)
                   if key in numbers},
                **check.compare(ref["reference"], cans, vecs, k, ivf=ivf,
                                pvf=pvf, w=w, targets=targets)}
            result["numbers"] = numbers
        return result
    finally:
        if tracer is not None and not stopped:
            tracer.stop()
        if srv is not None:
            srv.stop()
        fleet.close()


def main(argv=None, *, device: str | None = None,
         overrides: dict | None = None) -> int:
    """The command line (``run.py``); ``device`` and ``overrides`` as in
    :func:`run`, for tests."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m freddy_bench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 device=device, overrides=overrides)
    bad = forbidden_loaded()
    if bad:
        print(f"freddy_bench: forbidden modules loaded: {bad}",
              file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
