"""One run of one cell: set-up, warm-up, the measured window, the check
against the reference, and the result line.

Everything is found by name; nothing here names a cell, a traffic kind
or a metric:
  workloads/<cell>.json   its configuration, traffic, chips, why, the
                          limits of the check's numbers, the control's
                          precision and its per-layer metrics
  configs/<name>.json     the configuration as it is run
  traffic/<name>.json     a traffic mix: its kind, the end-to-end metric
                          it reports (name, unit, "rate" or
                          "seconds_per_step") and the kind's parameters
  traffic/<kind>.py       the kind: a ``Traffic(params, cfg, seed,
                          device, faults)`` that sets up its cards and the
                          program (``build_s``), and has ``setup(seconds)``
                          (warm-up), ``step(index)`` (a ``Step``),
                          ``release()`` and ``check(steps, precision)``
                          (the numbers compared and their worst items);
                          a kind whose ranks live in several processes
                          also has ``cards()`` and ``trace_ranks()``
                          (below)
  metrics/<name>.py       one reader a per-layer metric: ``UNIT``,
                          ``read(Reading)`` (None where it finds nothing),
                          and the work families it needs (``FAMILIES``)

Timing: ``setup_s`` runs from the interpreter's first statement to the
window's start (CUDA start-up, the kernel library, the genome, the
tables, the kind's set-up and warm-up).  The window runs steps one
after another until ``--seconds`` have passed, and ends at the end of
the step in flight then; its end-to-end metric is all of the window's
work over all of its time.  With ``--trace 1`` the window is recorded by
torch.profiler (CUDA activity) and the per-layer readers take their
numbers from the trace, the captured launches, the program's counters
and the host's clocks; the end-to-end metrics are left out of that line.

Cards: a kind without ``cards()`` runs in this process, and ``device``
reads the cards this process used (``count``: those holding memory;
``memory_peak_bytes``: the fullest one's ``max_memory_allocated``).  A
kind whose ranks live in several processes (traffic/permute_split.py)
is rank 0 in this one; its ``cards()``, called after the window and
before ``release()``, gives one entry a rank (rank, card, name, peak
bytes), which each rank reads of its own card, and with ``--trace 1``
the busy seconds of that rank's own trace, which ``trace_ranks()``
started on every other rank just before this process's profiler.
Then ``count`` is the cards that hold memory over all ranks,
``memory_peak_bytes`` the fullest card's, ``busy_s`` the mean over the
ranks, and ``device["ranks"]`` lists the entries.  Everything else is
rank 0's process alone: under ``--trace 1`` the trace (``idle``, the
per-layer readers' ``trace``), ``breakdown`` and the captured launches;
the spans; the counters, but for those the kind gathers from every rank
itself; and ``host``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import resource
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fscl_tpu")


def load_json(kind, name, root=HERE):
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} "
                         f"({path})")
    return json.loads(path.read_text())


def _load_module(folder, name):
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no {folder} module named {name!r} "
                         f"({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name):
    """The reader module metrics/<name>.py."""
    return _load_module("metrics", name)


def load_kind(kind):
    """The traffic kind module traffic/<kind>.py."""
    return _load_module("traffic", kind)


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


@dataclasses.dataclass
class Step:
    """One step of the window: its output and the work it completed."""

    seed: int | None
    result: object
    work: float
    counters: dict


@dataclasses.dataclass
class Reading:
    """What a per-layer reader may read."""

    trace: object  # devtrace.Trace
    least: dict  # work.Capture.least(): {family: (launches, seconds)}
    counters: dict  # summed program counters of the window's steps
    host: dict  # host_clocks() over the window


def host_clocks():
    """CPU seconds of the process (all threads) and of the main thread,
    which runs the window's steps and the program's host driver, and the
    process's involuntary context switches (another task took its core)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": time.process_time(), "main_cpu_s": time.thread_time(),
            "preempted": ru.ru_nivcsw}


def _cards(gen=None, device="cuda"):
    """(cards holding memory, peak bytes on the fullest, the kind's rank
    entries or None), read before the reference runs: over every rank
    where the kind ``gen`` has ``cards()``, else over this process's
    cards (on the tests' CPU: one, no bytes)."""
    import torch

    if hasattr(gen, "cards"):
        ranks = gen.cards()
        held = {e["card"] for e in ranks if e["memory_peak_bytes"] > 0}
        return (len(held),
                max((e["memory_peak_bytes"] for e in ranks), default=0),
                ranks)
    if device != "cuda":
        return 1, 0, None
    if not torch.cuda.is_available():
        return 0, 0, None
    peaks = [torch.cuda.max_memory_allocated(d)
             for d in range(torch.cuda.device_count())]
    return sum(p > 0 for p in peaks), max(peaks, default=0), None


def run_cell(args, t_start, device="cuda", faults=None, root=HERE,
             control=False):
    """(exit code, result dict or None).  ``device``, ``faults`` and
    ``root`` are for the tests: "cpu" skips the look for a card,
    ``faults(program)`` may break the program underneath before the
    window, and ``root`` holds the workloads, configs and traffic files.
    ``control`` (control.py) adds the control's numbers: the reference at
    the cell's control precision in the program's place."""
    import torch

    from . import check, devtrace, work

    cell = load_json("workloads", args.workload, root)
    cfg = load_json("configs", cell["config"], root)
    traffic = load_json("traffic", cell["traffic"], root)
    chips = int(cell["chips"])
    if device == "cuda":
        if not torch.cuda.is_available():
            print("portbench: torch.cuda.is_available() is false: this "
                  "benchmark runs on NVIDIA cards only", file=sys.stderr)
            return 2, None
        if torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2, None

    kind = load_kind(traffic["kind"])
    gen = kind.Traffic(traffic, cfg, args.seed, device, faults)
    gen.setup(args.seconds)
    gen.sync()

    readers = ({m: load_metric(m) for m in cell["per_layer"]}
               if args.trace else {})
    families = sorted({f for r in readers.values()
                       for f in getattr(r, "FAMILIES", ())})
    cap = work.Capture(families).install() if families else None
    if args.trace and hasattr(gen, "trace_ranks"):
        gen.trace_ranks()
    prof = devtrace.start(device == "cuda") if args.trace else None

    steps, counters = [], {}
    h0 = host_clocks()
    t0 = time.monotonic()
    setup_s = t0 - t_start
    while True:
        st = gen.step(len(steps))
        steps.append(st)
        for k, v in st.counters.items():
            counters[k] = counters.get(k, 0) + v
        if time.monotonic() - t0 >= args.seconds:
            break
    gen.sync()
    window_s = time.monotonic() - t0
    host = {k: v - h0[k] for k, v in host_clocks().items()}

    events = devtrace.stop(prof) if prof is not None else []
    if cap is not None:
        cap.remove()
    n_cards, peak, ranks = _cards(gen, device)
    cap_stats = cap.stats() if cap is not None else {}
    least = cap.least() if cap is not None else {}
    del cap

    # the program's state goes before the reference runs on the card
    gen.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    numbers, worst = gen.check(steps)
    controls = gen.check(steps, cell["control"])[0] if control else None
    correct, rows = check.judge(numbers, cell["limits"])
    build_s = gen.build_s
    del gen

    work_done = sum(s.work for s in steps)
    result = {
        "correct": bool(correct),
        "attempted": len(steps),
        "failed": 0 if correct else len(steps),
    }
    device_info = {
        "platform": "gpu" if device == "cuda" else device,
        "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                 else device),
        "count": n_cards,
        "memory_peak_bytes": int(peak),
    }
    if ranks is not None:
        device_info["ranks"] = ranks
    if args.trace:
        tr = devtrace.Trace(events, window_s)
        reading = Reading(trace=tr, least=least, counters=counters,
                          host=host)
        metrics = {}
        for name, mod in readers.items():
            v = mod.read(reading)
            if v is not None and math.isfinite(v):
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
        result["metrics"] = metrics
        busy = [tr.busy_s()]
        if ranks is not None:
            ranks[0]["busy_s"] = busy[0]
            busy += [e["busy_s"] for e in ranks[1:] if "busy_s" in e]
        device_info["busy_s"] = sum(busy) / len(busy)
        device_info["window_s"] = window_s
        result["breakdown"] = tr.breakdown()
    else:
        if traffic["measure"] == "rate":
            value = work_done / window_s
        elif traffic["measure"] == "seconds_per_step":
            value = window_s / len(steps)
        else:
            raise ValueError(f"unknown measure {traffic['measure']!r}")
        result["metrics"] = {
            traffic["metric"]: {"value": value, "unit": traffic["unit"]},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result["device"] = device_info
    # not read by the driver: what the run's set-up, window and host did
    result["setup"] = {"setup_s": setup_s, "build_s": build_s,
                       "window_s": window_s, "work": work_done,
                       "counters": counters, "host": host,
                       "capture": cap_stats}
    # popped by main(): the worst item of each number, every number read
    # and the control's numbers (control.py)
    result["worst"] = worst
    result["readings"] = numbers
    if controls is not None:
        result["control"] = controls
    # last: each number compared beside its limit
    result["checks"] = [{"name": n, "value": v, "limit": lim}
                        for n, v, lim in rows]
    return 0, result


def main(argv, t_start):
    args = parse(argv)
    code, result = run_cell(args, t_start)
    if result is None:
        return code
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; the benchmark "
              "and the port may not import JAX or the JAX package",
              file=sys.stderr)
        return 3
    result.pop("readings")
    for name, item in result.pop("worst").items():
        print(f"worst {name}: {json.dumps(item)}", file=sys.stderr)
    for c in result["checks"]:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
