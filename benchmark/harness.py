"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name: the workload in BENCHMARK.json,
its configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json``, its limits in ``limits/<workload>.json``, and
each per-layer metric's reader in ``metrics/<metric>.py``.

The window is one closed-loop client: it sends the traffic's requests in
turn to ``CaptionService.caption`` until ``seconds`` have passed and the
request in flight has returned.  With ``trace`` the harness also times
the service's ``prepare_chunk`` and ``decode_chunk`` (each span ends in a
device barrier), reads the port's counters, and, once the window has
closed, traces a short stretch of requests with torch.profiler; the
end-to-end metrics come from runs without it.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark import weights
from benchmark.arith import timeline as tl
from benchmark.reference.check import Caption, Served, compare, judge, vocab
from benchmark.reference.model import Reference
from benchmark.spec import argv_of, spec_of
from benchmark.traffic import load as load_traffic

WARMUP_REQUESTS = 2  # set-up: the cell's own shapes, twice
PROFILE_REQUESTS = 2  # traced run: requests under torch.profiler, after the window
KEEP_PER_REQUEST = 2  # videos of each request whose captions are kept for the check
FORBIDDEN = ("jax", "jaxlib", "flax", "echr_tpu")


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def workload(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest: Dict, kind: str, name: str) -> List[Dict]:
    return [m for m in manifest[kind] if name in m.get("workloads", [name])]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def port_counters() -> Dict[str, Tuple[object, str]]:
    """Every counter the port exposes, over its modules loaded now: an int
    attribute that one of its functions carries (a kernel wrapper's
    ``launches``, a decoder's ``steps`` and ``host_syncs``), by
    "<function>.<attribute>", or "<module>.<function>.<attribute>" where
    two functions share a name.  A counter the port adds is found here
    with no edit of the benchmark."""
    found: Dict[str, Tuple[object, str]] = {}
    for mod_name, mod in sorted(sys.modules.items()):
        if mod is None or mod_name.split(".")[0] != "echr_tpu_torch":
            continue
        for obj in list(vars(mod).values()):
            if not isinstance(obj, types.FunctionType) or obj.__module__ != mod_name:
                continue
            for attr, val in vars(obj).items():
                if type(val) is not int:
                    continue
                key = f"{obj.__qualname__}.{attr}"
                if key in found and found[key][0] is not obj:
                    key = f"{mod_name}.{key}"
                found[key] = (obj, attr)
    return found


class Tracer:
    """The traced run's spans and counters around the service's chunk calls:
    a chunk's record holds its shapes, the live (row, frame) pairs of its
    windows, the seconds of each span, and the change of every counter of
    ``port_counters`` over the chunk."""

    def __init__(self, svc):
        self.chunks: List[Dict] = []
        self.request = -1
        self.profiled = False
        self.counters = port_counters()
        dev = svc.device
        prep, dec = svc.prepare_chunk, svc.decode_chunk

        def prepare_chunk(chunk, bucket):
            with torch.profiler.record_function("bench.prepare_chunk"):
                t0 = time.perf_counter()
                out = prep(chunk, bucket)
                _sync(dev)
                t1 = time.perf_counter()
            sels, nb, args = out
            frames = args[5].sum(dim=1).cpu().numpy()
            live = 0
            for (_, soi, _, _), n in zip(sels, frames):
                w = np.asarray(soi, np.int64).reshape(-1, 2)[:nb]
                live += int((np.minimum(w[:, 1], int(n)) - w[:, 0]).clip(min=0).sum())
            self._chunk = {"request": self.request, "profiled": self.profiled,
                           "B": len(sels), "nb": int(nb), "T": int(args[5].shape[1]),
                           "live": live, "prepare_s": t1 - t0}
            return out

        def decode_chunk(chunk, bucket):
            before = self._read()
            with torch.profiler.record_function("bench.decode_chunk"):
                t0 = time.perf_counter()
                out = dec(chunk, bucket)  # calls prepare_chunk first
                _sync(dev)
                t1 = time.perf_counter()
            after = self._read()
            self._chunk.update(decode_s=t1 - t0,
                               counters={k: after[k] - before[k] for k in after})
            self.chunks.append(self._chunk)
            return out

        svc.prepare_chunk, svc.decode_chunk = prepare_chunk, decode_chunk

    def _read(self) -> Dict[str, int]:
        return {k: getattr(obj, attr) for k, (obj, attr) in self.counters.items()}


def _reader(bench: Path, name: str):
    path = bench / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell(NamedTuple):
    """A cell after set-up: the service warm, its inputs, the yardstick."""

    spec: object
    traffic: object
    svc: object
    reqs: List
    trees: Tuple  # (tap, captioner) param trees, numpy
    limits: Dict
    dev: torch.device
    setup_s: float


def set_up(bench: Path, manifest: Dict, name: str, seed: int, device: str, t_start: float,
           log=print, program_flags: Optional[Dict] = None) -> Cell:
    """Read the cell's files, draw its traffic and weights from ``seed``,
    build the service on ``device`` and warm it on the cell's own shapes.
    ``program_flags`` changes flags of the port's configuration alone (a
    witness run of calibrate.py); the yardstick reads the file's."""
    from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
    from echr_tpu_torch.config import parse_config
    from echr_tpu_torch.serve import CaptionRequest, CaptionService

    cell = workload(manifest, name)
    conf = load_json(bench / "configs" / f"{cell['config']}.json")
    limits = load_json(bench / "limits" / f"{name}.json")
    spec = spec_of(conf["flags"])
    cfg = parse_config(argv_of({**conf["flags"], **(program_flags or {})}))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)

    marks = [("imports", time.time())]
    traffic = load_traffic(bench / "traffic" / f"{cell['traffic']}.json", spec, seed, dev)
    marks.append(("traffic", time.time()))
    trees = weights.numpy_trees(weights.draw(spec, seed, dev))
    marks.append(("weights", time.time()))
    svc = CaptionService(cfg, tap_from_jax(trees[0], cfg, dev),
                         captioner_from_jax(trees[1], cfg, dev), vocab(spec.vocab), device=dev,
                         batch_videos=traffic.videos_per_request, topN=traffic.topN,
                         beam_size=traffic.beam_size)
    reqs = [[CaptionRequest(v.vid, v.feats, v.duration, v.lda) for v in r]
            for r in traffic.requests]
    marks.append(("service", time.time()))
    for i in range(WARMUP_REQUESTS):
        svc.caption(reqs[traffic.request(i)])
        _sync(dev)
        marks.append((f"warm-up {i}", time.time()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    steps = ", ".join(f"{n} {t - t0:.3f}" for (n, t), (_, t0)
                      in zip(marks, [("start", t_start)] + marks[:-1]))
    log(f"set-up {setup_s:.3f} s ({steps}): {len(traffic.requests)} distinct requests of "
        f"{traffic.videos_per_request} videos, beam {traffic.beam_size}, top {traffic.topN}")
    return Cell(spec, traffic, svc, reqs, trees, limits, dev, setup_s)


class _GCClock:
    """Seconds the interpreter's garbage collector ran, by request."""

    def __init__(self):
        self.total, self._t = 0.0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.total += time.perf_counter() - self._t
            self._t = None

    def take(self) -> float:
        t, self.total = self.total, 0.0
        return t

    def close(self) -> None:
        gc.callbacks.remove(self._cb)


class Window(NamedTuple):
    requests: List[Dict]
    kept: Dict  # (distinct request, video) -> its served captions (Kept), or None
    flops: Dict  # traced: distinct request -> the FLOPs its served captions need
    failed: int
    missing: int  # videos of completed requests that came back without captions
    seconds: float
    tracer: Optional[Tracer]
    prof: object


def serve(c: Cell, seconds: float, trace: bool, rng, max_requests: int = 0,
          log=print) -> Window:
    """The measured window: one closed-loop client sends the traffic's
    requests in turn until ``seconds`` have passed (or ``max_requests``
    were sent) and the request in flight has returned.  With ``trace``,
    the chunks' spans and counters are read throughout, and once the
    window has closed ``PROFILE_REQUESTS`` more requests run under
    torch.profiler: the profiler's tracing slows every launch after it
    starts, so it starts after the requests that the spans time."""
    traffic, dev = c.traffic, c.dev
    tracer = Tracer(c.svc) if trace else None
    requests: List[Dict] = []
    kept: Dict = {}
    flops: Dict[int, float] = {}
    failed = missing = 0
    gc_clock = _GCClock()

    def send():
        nonlocal failed, missing
        i = len(requests)
        p = traffic.request(i)
        if tracer is not None:
            tracer.request = i
        ts = time.perf_counter()
        with torch.profiler.record_function("bench.caption"):
            try:
                res = c.svc.caption(c.reqs[p])
            except Exception as e:  # a failed request counts; the loop goes on
                log(f"request {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
                res = None
                failed += 1
            _sync(dev)
        te = time.perf_counter()
        n = 0 if res is None else sum(len(cs) for cs in res.values())
        requests.append({"index": i, "pool": p, "start": ts, "end": te, "captions": n,
                         "profiled": tracer is not None and tracer.profiled,
                         "gc_s": gc_clock.take()})
        if res is not None:
            missing += sum(v.vid not in res for v in traffic.requests[p])
            if trace and p not in flops:
                flops[p] = _request_flops(c, p, res)
        for j in rng.choice(traffic.videos_per_request, KEEP_PER_REQUEST, replace=False):
            v = traffic.requests[p][int(j)]
            kept[(p, int(j))] = None if res is None else Kept.of(res.get(v.vid))

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds and not (max_requests and
                                                      len(requests) >= max_requests):
        send()
    window_s = time.perf_counter() - t0
    prof = None
    if tracer is not None:
        tp = time.perf_counter()
        with _profiler(dev):  # the profiler's first start is slow: not in the stretch
            _sync(dev)
        log(f"profiler warm-up {time.perf_counter() - tp:.3f} s")
        prof = _profiler(dev)
        prof.start()
        tracer.profiled = True
        for _ in range(PROFILE_REQUESTS):
            send()
        prof.stop()
        tracer.profiled = False
    gc_clock.close()
    return Window(requests, kept, flops, failed, missing, window_s, tracer, prof)


def sample(c: Cell, w: Window, rng) -> List:
    """The videos the check judges: ``limits["videos"]`` kept ones drawn
    from the seed, and the kept one with the most served tokens.  Each is
    a reference.check.Served, or None where its request failed."""
    keys = sorted(w.kept)
    pick = [keys[int(x)] for x in rng.choice(len(keys), min(len(keys), c.limits["videos"]),
                                            replace=False)]
    longest = max(keys, key=lambda k: (-1 if w.kept[k] is None else w.kept[k].tokens, k))
    if longest not in pick:
        pick.append(longest)
    out = []
    for p, j in pick:
        v = c.traffic.requests[p][j]
        caps = w.kept[(p, j)]
        out.append(None if caps is None else Served(v.feats, v.lda, v.duration, caps.captions()))
    return out


def reference(c: Cell, precision: str = "f32") -> Reference:
    return Reference(c.spec, *(_to_device(t, c.dev) for t in c.trees), precision=precision)


def run_cell(bench: Path, manifest: Dict, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, log=print) -> Dict:
    """Run the cell ``name`` once; returns the result line's dict, with the
    numbers compared under "checks"."""
    c = set_up(bench, manifest, name, seed, device, t_start, log)
    rng = np.random.default_rng(int(seed) % 2**63)
    w = serve(c, seconds, trace, rng, log=log)
    dev = c.dev
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    timed = [r for r in w.requests if not r["profiled"]]  # the window's requests
    lat = [r["end"] - r["start"] for r in timed]
    n_caps = sum(r["captions"] for r in timed)
    q = np.percentile(lat, [0, 10, 50, 90, 100]) * 1e3 if lat else []
    log(f"window {w.seconds:.3f} s: {len(timed)} requests, {w.failed} failed, "
        f"{w.missing} videos missing, {n_caps} captions; request ms min, p10, median, p90, "
        f"max " + ", ".join(f"{x:.1f}" for x in q)
        + f"; garbage collection {sum(r['gc_s'] for r in timed):.3f} s"
        + f"; {len(w.requests) - len(timed)} profiled after it")
    log("request ms (distinct request, ms, of it gc ms): " + " ".join(
        f"{r['pool']}:{1e3 * (r['end'] - r['start']):.0f}:{1e3 * r['gc_s']:.0f}"
        for r in w.requests), file=sys.stderr)
    record = _record(bench, w, c) if trace else None
    c = c._replace(svc=None)
    w = w._replace(tracer=None, prof=None)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: the process holds {found} after the window")

    tc = time.perf_counter()
    verdict = judge(reference(c), sample(c, w, rng), c.traffic.topN, c.traffic.beam_size)
    verdict["numbers"]["malformed"] += w.missing
    log(f"check {time.perf_counter() - tc:.3f} s over {verdict['seen']}; not compared: "
        f"{verdict['info']}")
    checks, ok = compare(verdict["numbers"], c.limits)
    result: Dict = {"correct": bool(ok and w.failed == 0 and n_caps > 0),
                    "attempted": len(w.requests), "failed": w.failed}

    metrics = {}
    if not trace:
        values = {"captions_per_s": n_caps / w.seconds, "request_p90_ms": 1e3 * _p90(lat),
                  "setup_s": c.setup_s}
        for m in metrics_of(manifest, "end_to_end", name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in metrics_of(manifest, "per_layer", name):
            v = _reader(bench, m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                        "count": 1, "memory_peak_bytes": int(peak)}
    if record is not None and record["timeline"] is not None:
        t = record["timeline"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {
            "device_ops": [[k[:160], v] for k, v in sorted(t["kernels_s"].items(),
                                                           key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in tl.label_gaps(t)]}
    result["checks"] = checks
    return result


class Kept(NamedTuple):
    """One video's served captions held as a few arrays and one string,
    so that what the check keeps adds next to nothing to the objects the
    interpreter's collector walks during the window."""

    timestamps: np.ndarray  # [n, 2] float64
    scores: np.ndarray  # [n, 2]: proposal_score, sentence_confidence
    sentences: str  # joined by newlines
    tokens: int  # words and END tokens

    @classmethod
    def of(cls, caps) -> Optional["Kept"]:
        if caps is None:
            return None
        text = "\n".join(c.sentence for c in caps)
        return cls(np.array([c.timestamp for c in caps], np.float64).reshape(-1, 2),
                   np.array([(c.proposal_score, c.sentence_confidence) for c in caps],
                            np.float64).reshape(-1, 2),
                   text, len(text.split()) + len(caps))

    def captions(self) -> List[Caption]:
        sents = self.sentences.split("\n") if len(self.timestamps) else []
        return [Caption(tuple(t), s, float(sc[0]), float(sc[1]))
                for t, s, sc in zip(self.timestamps.tolist(), sents, self.scores)]


def _p90(values: List[float]) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def _to_device(tree, dev):
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=dev)
    if isinstance(tree, list):
        return [_to_device(x, dev) for x in tree]
    return {k: _to_device(v, dev) for k, v in tree.items()}


def _profiler(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _record(bench: Path, w: Window, c: Cell) -> Dict:
    """What the per-layer readers read: the requests (with the FLOPs their
    captions need), the chunks' spans, shapes and counters, and the
    profiled stretch's timeline."""
    for r in w.requests:
        r["flops"] = w.flops.get(r["pool"], 0.0) if r["captions"] else 0.0
    timeline = None
    if w.prof is not None:
        out = bench / "out"
        out.mkdir(exist_ok=True)
        path = out / "trace.json"
        w.prof.export_chrome_trace(str(path))
        timeline = tl.read(str(path))
        path.unlink()
    return {"requests": w.requests, "chunks": w.tracer.chunks, "timeline": timeline,
            "spec": c.spec, "beam_size": c.traffic.beam_size}


def _request_flops(c: Cell, p: int, res: Dict) -> float:
    """The FLOPs the served captions of distinct request ``p`` need."""
    from benchmark.arith.flops import request_flops

    vids = []
    for v in c.traffic.requests[p]:
        caps = res.get(v.vid, [])
        vids.append((len(v.feats), [(_window(x, v), len(x.sentence.split())) for x in caps]))
    return request_flops(c.spec, vids, c.traffic.beam_size)


def _window(caption, video) -> int:
    """Frames in a served caption's window, from its timestamps."""
    tpf = video.duration / len(video.feats)
    return max(1, int(round((caption.timestamp[1] - caption.timestamp[0]) / tpf)))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them, and the
    device count."""
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    name = torch.cuda.get_device_name(0)
    return f"card: {smi[0] if smi else name}; devices {torch.cuda.device_count()}"

