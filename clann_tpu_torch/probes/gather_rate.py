"""Gather-rate probe on one GPU: the candidate-record gather of the LSH
engines, plain PyTorch against the hand-written kernels K4-K7.

    python -m clann_tpu_torch.probes.gather_rate [--iters 20] [--reps 6] [--out PATH]
    python -m clann_tpu_torch.probes.gather_rate --kernel-times [--out PATH]

The port of scripts/exp_gather_rate.py and scripts/exp_pallas_gather.py
(whose TPU results are GATHER_RATE.json and PALLAS_GATHER.json; this probe
writes no file unless `--out` names one):

- the indexed record gather rec[t, b] of (L, nb, G * R) records at
  G = 8, 16, 32, 64, 128 (1.2M slots, L = 50, R = 4), its flat-index
  variant flat[t * nb + b], and K7 (`ops.gather.gather_rows`) at G = 16, 64;
- K7 at the global engine's shape (L = 128, G = 32, 1,183,520 slots);
- on the (T = 1,849,250, W = 128) word table of the G = 32 production
  layout: the plain take (the scripts' `xla_take_G32`), K4 on 4 KB pages
  (T / 8 of them), K5 on aligned 8-row groups, K6 on 128-word slices of the
  flat view;

each kernel at inflight 8, 16 and 32 (the TPU kernels' NSEM values), with
131,072 rows per iteration. Every row runs `iters` iterations, each on its
own rotated index vector (made before the timing), timed by CUDA events
around a Python loop of the calls (`time_iters`); the best of `reps` is
kept. Fields per row, as in the scripts: ms_per_iter, ns_per_row, gbps
(bytes moved), useful_gbps (bytes of the wanted rows) and, for kernels,
correct (bit-equal to the plain version on the first index vector).

`--kernel-times` runs `path_times` instead: `kernel_times` of K7 at the
global engine's 512-byte records and at the clustered walk's 192-byte
records (L = 50, G = 16, R = 3, 65,536 rows per iteration) and of K6 on the
(T, 128) table above. `kernel_times` is the timing that `chip_smoke.py`'s
`[gather-time]` lines use: a wrapper, its plain version and one
`torch.index_select` on the same rotated index vectors, each timed twice,
device ms by `time_graph` (the replay of a CUDA graph of the calls: the
device's time alone) and call ms by `time_iters` (the host's work per call
included), and the wrapper's device ms at every inflight.

Needs a CUDA device; the card's name and power limit are printed and
recorded beside the numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, Dict, List, Optional

import torch

from clann_tpu_torch.ops import gather as tg

ROWS = 131_072  # gathered rows per iteration (both scripts)
PEAK_BYTES_PER_S = 3.35e12  # one H100 SXM's device memory (NVIDIA's data sheet)
N_SLOTS, L_PROBE, R = 1_200_000, 50, 4  # exp_gather_rate.py
GS = (8, 16, 32, 64, 128)
K7_GS = (16, 64)
NSEMS = (8, 16, 32)
# exp_pallas_gather.py's production table: n_slots 1,183,520, L 50, G 32
TAKE_SLOTS, TAKE_G = 1_183_520, 32
# the global engine at the LSH configuration (L 128, G 32)
ENGINE_L, ENGINE_G = 128, 32
# the clustered walk (the README quickstart's L 50, gather_block 16, 3-word
# slot records) on 1,183,514 points: one 256-query batch gathers 256 *
# chunk 512 * filter_expand 8 / G = 65,536 block rows of 192 B
WALK_L, WALK_G, WALK_R, WALK_POINTS, WALK_ROWS = 50, 16, 3, 1_183_514, 65_536


def rate_row(ms: float, *, rows: int, row_bytes: int, useful_bytes: int, **extra) -> dict:
    """One result row in the scripts' fields."""
    s = ms / 1e3
    return dict(rows=int(rows), row_bytes=int(row_bytes), ms_per_iter=ms,
                ns_per_row=s * 1e9 / rows, gbps=rows * row_bytes / s / 1e9,
                useful_gbps=rows * useful_bytes / s / 1e9, **extra)


def random_words(shape, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32, generator=gen,
                         device=device)


def rotated(idx: torch.Tensor, n: int, iters: int) -> List[torch.Tensor]:
    """The scripts' iteration-dependent indices, (idx + i) % n, made ahead."""
    return [((idx.to(torch.int64) + i) % n).to(torch.int32) for i in range(iters)]


def time_iters(fn: Callable, args_per_iter: List, reps: int) -> float:
    """Best-of-`reps` mean ms of one fn(*args) call, CUDA events around a
    Python loop over every iteration's arguments (after a warm-up pass):
    the call's time as its caller sees it, the host's work included."""
    for a in args_per_iter:
        fn(*a)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for a in args_per_iter:
            fn(*a)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / len(args_per_iter))
    return best


def time_graph(fn: Callable, args_per_iter: List, reps: int) -> float:
    """Best-of-`reps` mean ms of one fn(*args) call on the device alone: one
    pass over every iteration's arguments (made before; the outputs are
    allocated inside) is captured in a CUDA graph after a warm-up pass, and
    the graph's replay is timed by CUDA events. The wrappers launch on the
    current stream, which is the capture stream inside `torch.cuda.graph`."""
    for a in args_per_iter:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in args_per_iter:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / len(args_per_iter))
    return best


def run(device="cuda", *, iters: int = 20, reps: int = 6, rows: int = ROWS,
        log: Optional[Callable[[str], None]] = None) -> Dict[str, dict]:
    """Every row of the probe; {tag: row}."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    res: Dict[str, dict] = {}

    def record(tag, fn, args, row_bytes, useful_bytes, **extra):
        res[tag] = rate_row(time_iters(fn, args, reps), rows=rows, row_bytes=row_bytes,
                            useful_bytes=useful_bytes, **extra)
        if log:
            r = res[tag]
            log(f"[gather-rate] {tag}: {r['ms_per_iter']:.4f} ms/iter, {r['ns_per_row']:.2f} "
                f"ns/row, {r['gbps']:.1f} GB/s moved, {r['useful_gbps']:.1f} GB/s useful"
                + (f", correct {extra['correct']}" if "correct" in extra else ""))

    def kernel_rows(prefix, kern, plain, args, row_bytes, useful_bytes):
        want = plain(*args[0])
        for ns in NSEMS:
            ok = bool(torch.equal(kern(*args[0], inflight=ns), want))
            record(f"{prefix}_s{ns}", lambda *a, ns=ns: kern(*a, inflight=ns), args,
                   row_bytes, useful_bytes, correct=ok)

    # exp_gather_rate.py: indexed and flat-index gathers, K7 at G 16 / 64
    for G in GS:
        nb = N_SLOTS // G
        rec = random_words((L_PROBE, nb, G * R), gen, dev)
        t_idx = torch.randint(0, L_PROBE, (rows,), generator=gen, device=dev)
        b_sets = rotated(torch.randint(0, nb, (rows,), generator=gen, device=dev), nb, iters)
        record(f"torch_G{G}", lambda b: rec[t_idx, b.to(torch.int64)],
               [(b,) for b in b_sets], G * R * 4, G * R * 4)
        flat = rec.view(L_PROBE * nb, G * R)
        fidx = [(t_idx * nb + b).to(torch.int32) for b in b_sets]
        record(f"torch_flat_G{G}", lambda f: flat[f.to(torch.int64)], [(f,) for f in fidx],
               G * R * 4, G * R * 4)
        if G in K7_GS:
            kernel_rows(f"k7_G{G}", tg.gather_rows, tg.rows_plain,
                        [(flat, f) for f in fidx], G * R * 4, G * R * 4)
        del rec, flat

    # the global engine's record table: (L * nb, G * R) at L 128, G 32
    nb = TAKE_SLOTS // ENGINE_G
    table = random_words((ENGINE_L * nb, ENGINE_G * R), gen, dev)
    idx = rotated(torch.randint(0, ENGINE_L * nb, (rows,), generator=gen, device=dev),
                  ENGINE_L * nb, iters)
    width = ENGINE_G * R * 4
    record(f"torch_engine_L{ENGINE_L}_G{ENGINE_G}", tg.rows_plain,
           [(table, i) for i in idx], width, width)
    kernel_rows(f"k7_engine_L{ENGINE_L}_G{ENGINE_G}", tg.gather_rows, tg.rows_plain,
                [(table, i) for i in idx], width, width)
    del table

    # exp_pallas_gather.py: the (T, 128) table of the G = 32 layout
    T, W = L_PROBE * (TAKE_SLOTS // TAKE_G), TAKE_G * R
    table = random_words((T, W), gen, dev)
    idx = rotated(torch.randint(0, T, (rows,), generator=gen, device=dev), T, iters)
    record("torch_take_G32", tg.rows_plain, [(table, i) for i in idx], W * 4, W * 4)
    flat = table.view(-1)
    record("torch_flat1d", lambda f, i: tg.flat1d_plain(f, i, width=W),
           [(flat, i) for i in idx], W * 4, W * 4)
    kernel_rows("flat1d", lambda f, i, inflight: tg.gather_flat1d(f, i, width=W,
                                                                   inflight=inflight),
                lambda f, i: tg.flat1d_plain(f, i, width=W), [(flat, i) for i in idx],
                W * 4, W * 4)
    n_groups = T // 8
    gidx = rotated(torch.randint(0, n_groups, (rows,), generator=gen, device=dev),
                   n_groups, iters)
    record("torch_group8", tg.group8_plain, [(table, g) for g in gidx], 8 * W * 4, W * 4)
    kernel_rows("group8", tg.gather_group8, tg.group8_plain, [(table, g) for g in gidx],
                8 * W * 4, W * 4)
    del table, flat
    pages = random_words((n_groups, 8, 128), gen, dev)
    pidx = gidx
    record("torch_page4k", tg.pages_plain, [(pages, p) for p in pidx], 4096, 4096)
    kernel_rows("page4k", tg.gather_pages, tg.pages_plain, [(pages, p) for p in pidx],
                4096, 4096)
    del pages
    return res


def kernel_times(kern: Callable, plain: Callable, library: Callable, sets: List,
                 reps: int = 3) -> Dict[str, dict]:
    """A gather wrapper `kern(i, **kw)`, its plain version and its library
    call on the same index vectors, in turns (plain, kernel, kernel, plain,
    library), each timed two ways: device ms (`time_graph`) and call ms
    (`time_iters`); then the wrapper's device ms at every inflight.
    {"kernel" | "plain" | "library": {device_ms, call_ms (means),
    device_each}, "inflight": {inflight: device ms}}."""
    runs: Dict[str, list] = {}
    for name, fn in (("plain", plain), ("kernel", kern), ("kernel", kern), ("plain", plain),
                     ("library", library)):
        runs.setdefault(name, []).append((time_graph(fn, sets, reps), time_iters(fn, sets, reps)))
    res: Dict[str, dict] = {
        name: dict(device_ms=sum(d for d, _ in t) / len(t), call_ms=sum(c for _, c in t) / len(t),
                   device_each=[d for d, _ in t]) for name, t in runs.items()}
    res["inflight"] = {f: time_graph(lambda i, f=f: kern(i, inflight=f), sets, reps)
                       for f in tg.INFLIGHT_CHOICES}
    return res


def path_times(device="cuda", *, iters: int = 20, reps: int = 3,
               log: Optional[Callable[[str], None]] = None) -> Dict[str, dict]:
    """kernel_times of K7 at the engine's and the walk's records and of K6,
    on random words; {tag: its readings with rows, row_bytes, bound_ms (each
    wanted row read once and written once, and the indices) and correct
    (the wrapper's default equal to the plain version)}."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    res: Dict[str, dict] = {}

    def shape(tag, table, kern, plain, rows):
        n_src, W = table.shape
        sets = [(i,) for i in rotated(torch.randint(0, n_src, (rows,), generator=gen,
                                                    device=dev), n_src, iters)]
        r = kernel_times(kern, plain, lambda i: torch.index_select(table, 0, i), sets, reps)
        bound = rows * (2.0 * W * 4 + 4) / PEAK_BYTES_PER_S * 1e3
        r.update(rows=rows, row_bytes=W * 4, bound_ms=bound,
                 correct=bool(torch.equal(kern(sets[0][0]), plain(sets[0][0]))))
        res[tag] = r
        if log:
            k = r["kernel"]
            log(f"[kernel-times] {tag}: device {k['device_ms']:.4f} ms "
                f"({bound / k['device_ms']:.3f} of the {bound:.4f} ms bound), call {k['call_ms']:.4f} ms; by inflight "
                + ", ".join(f"{f}: {ms:.4f}" for f, ms in r["inflight"].items())
                + f"; plain {r['plain']['device_ms']:.4f} / {r['plain']['call_ms']:.4f}, "
                f"index_select {r['library']['device_ms']:.4f} / {r['library']['call_ms']:.4f}; "
                f"correct {r['correct']}")

    # the global engine's records: (L * nb, G * R) at L 128, G 32 (512 B)
    table = random_words((ENGINE_L * (TAKE_SLOTS // ENGINE_G), ENGINE_G * R), gen, dev)
    shape(f"k7_engine_L{ENGINE_L}_G{ENGINE_G}", table,
          lambda i, **kw: tg.gather_rows(table, i, **kw), lambda i: tg.rows_plain(table, i), ROWS)
    del table
    # the clustered walk's slot records: (L * nb, G * R) at L 50, G 16, R 3
    table = random_words((WALK_L * -(-WALK_POINTS // WALK_G), WALK_G * WALK_R), gen, dev)
    shape(f"k7_walk_L{WALK_L}_G{WALK_G}_R{WALK_R}", table,
          lambda i, **kw: tg.gather_rows(table, i, **kw), lambda i: tg.rows_plain(table, i),
          WALK_ROWS)
    del table
    # K6: 128-word slices of the flat (T * 128,) view of the G = 32 table
    T, W = L_PROBE * (TAKE_SLOTS // TAKE_G), TAKE_G * R
    table = random_words((T, W), gen, dev)
    flat = table.view(-1)
    shape("k6_flat1d", table, lambda i, **kw: tg.gather_flat1d(flat, i, width=W, **kw).view(-1, W),
          lambda i: tg.flat1d_plain(flat, i, width=W).view(-1, W), ROWS)
    del table, flat
    return res


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    ap.add_argument("--kernel-times", action="store_true",
                    help="time K6 and K7 at their paths' shapes (path_times) instead")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("gather_rate needs a CUDA device: its numbers are the card's")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"[gather-rate] {torch.cuda.get_device_name(dev)}; {card}", file=sys.stderr,
          flush=True)
    results = (path_times if args.kernel_times else run)(
        dev, iters=args.iters, reps=args.reps,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    line = json.dumps({
        "device": torch.cuda.get_device_name(dev), "nvidia_smi": card,
        "config": {"rows_per_iter": ROWS, "iters": args.iters, "reps": args.reps,
                   "slots": N_SLOTS, "L": L_PROBE, "R": R,
                   "engine": {"L": ENGINE_L, "G": ENGINE_G, "slots": TAKE_SLOTS},
                   "walk": {"L": WALK_L, "G": WALK_G, "R": WALK_R, "points": WALK_POINTS,
                            "rows_per_iter": WALK_ROWS}},
        "results": results,
    })
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
