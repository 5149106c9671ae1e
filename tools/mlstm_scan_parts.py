"""Where the mLSTM scan kernels' time goes, on the card.

K9 (``csrc/mlstm_scan.cu``) and K9-bwd (``csrc/mlstm_scan_bwd.cu``) at
xlstm-350m's (B, S, H, dk) = (1, 4096, 4, 512), (x1), and (2, 1024, 4,
512), (x2), and at the reduced trainer's (2, 100, 4, 128), (x4), on
random inputs (q, k, v, dh of O(1), log_f a log-sigmoid of N(2, 1), as
``chip_smoke.py`` phase 3 draws them):

1. each kernel's call, CUDA events over 5 calls, three times; and its
   kernels' device time a call, ``torch.profiler`` over 10 calls (the
   call less that is the host's launch cost);
2. K9-bwd at (x1) split by launch: ``torch.profiler``'s device time of
   each of its CUDA kernels over 3 calls;
3. K9-bwd's walk split into its recompute and its walk back: the source
   built once more with the walk back taken out (its outputs are wrong on
   purpose), timed as in 1; the walk back is the call less that;
4. where the walk runs on thread-block clusters (``kCluster`` in the
   source), K9-bwd at (x1) built again at each cluster size 1-16, with
   how many clusters of that size fit the card at once;
5. for those kernels, clock stamps (``clock64``) of thread 0 of block 0
   at the stages of the walk (K9-bwd) and of a staged tile (K9), summed
   over one call at (x1): where a block's cycles go;
6. K9-bwd at (x1) built again with one part of the walk taken out each
   time (the cluster's sums; the reduce-scatters of dv and df; the
   recompute's recurrence; the forward pass to the sub-chunks' starts;
   the sends of the partial sums): the call less a variant's bounds what
   that part costs on the critical path.

Given checkouts (``ROOT ...``, each a tree of this repository, e.g. an
older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), it measures each in a process of its own, in the
order given, so that two versions compare on one card: pass them as
``A B B A`` (``--quick``: part 1 alone).  One JSON line a checkout.
Needs the card and nvcc::

    PYTHONPATH=src python tools/mlstm_scan_parts.py [--quick] [ROOT ...]
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = {"x1": (1, 4096, 4, 512), "x2": (2, 1024, 4, 512),
          "x4": (2, 100, 4, 128)}

#: The edits that take the walk back out of each version of the walk:
#: its loop made to run no step (and, where the walk back sends the
#: partial sums that a unit's mbarrier counts, no bytes expected); the
#: first set whose texts are each found once applies.
NO_WALK_BACK = (
    (("    for (int s = steps - 1; s >= 0; --s) {",
      "    for (int s = -1; s >= 0; --s) {"),),
    (("      for (int t = last; t >= lo; t -= kG) {  // the walk back",
      "      for (int t = lo - kG; t >= lo; t -= kG) {  // the walk back"),
     ("                    : 4u * (hi - lo) * (2 * D + (rank == 0 ? cl * W "
      ": 0)));",
      "                    : 0u);")),
)


#: Clock stamps of thread 0 of block 0: each STAMP(k) adds the cycles
#: since the last stamp to stage k; (anchor, stage name) a kernel, each
#: STAMP put before its anchor.
STAMP = ("__device__ long long stamp_acc[8];\n"
         "#define STAMP(K) if (threadIdx.x == 0 && blockIdx.x == 0 && "
         "blockIdx.y == 0) { const long long now_ = clock64(); "
         "stamp_acc[K] += now_ - stamp_prev; stamp_prev = now_; }\n")
READ_STAMPS = ('\nextern "C" int read_stamps(void* host) {\n'
               "  return (int)cudaMemcpyFromSymbol(host, stamp_acc, "
               "sizeof(stamp_acc));\n}\n")
WALK_STAMPS = (
    ("    // pass 1: the start of each sub-chunk", "stage the chunk"),
    ("    // pass 2: sub-chunks last to first", "pass 1"),
    ("      // the last sub-chunk's sums, once they have all come in", "recompute"),
    ("        finish(pend_lo, pend_steps, buf ^ 1);", "sums' arrival"),
    ("      for (int t = last; t >= lo; t -= kG) {  // the walk back",
     "sums, cluster wait"),
    ("      // every thread's arrival: its dv partials", "walk back"),
)
WALK_START = ("  cluster.sync();  // every block has started, its mbarriers made\n",
              "  long long stamp_prev = clock64();\n")
FWD_STAMPS = (
    ("    cp_wait_all();\n    __syncthreads();  // tile t landed", "steps"),
    ("    if (t + 1 < n_tiles) {\n      load_tile<D>", "tile landed, barrier"),
    ("    if (!service) {", "next tile's copies"),
    ("    __syncthreads();  // the tile's i k", "tile's shared values"),
    ("    if (service) {  // beside the tile's steps", "barrier"),
    ("    // a step: (i k, q s, v) of the tile's row s", "save C"),
    ("  __syncthreads();\n  if (service) store_h", "steps"),
)
FWD_START = ("  load_tile<D>(smem, q, k, v, b, head, heads, seq_len, col0, 0,",
             "  long long stamp_prev = clock64();\n")


def stamped(src: str, stamps, start) -> str:
    """``src`` with a STAMP(k) before each anchor and the stamps' clock
    started before ``start[0]``."""
    src = src.replace("namespace {\n", STAMP + "namespace {\n", 1)
    names = list(dict.fromkeys(name for _, name in stamps))
    for anchor, name in stamps:
        if src.count(anchor) != 1:
            raise ValueError(f"not found once: {anchor!r}")
        src = src.replace(anchor,
                          f"    STAMP({names.index(name)})\n" + anchor)
    return src.replace(start[0], start[1] + start[0], 1) + READ_STAMPS


#: K9-bwd's walk with one part taken out (its outputs are wrong on
#: purpose): (name, edits), each text found once.
WALK_PARTS = (
    ("no sums", (("  auto finish = [&](int t_lo, int steps, int buf) {\n",
                  "  auto finish = [&](int t_lo, int steps, int buf) {\n"
                  "    if (steps > 0) return;\n"),)),
    ("no row sums", tuple(
        (f"    scatter_round<16, 4>({x}, lane);\n"
         f"    scatter_round<8, 2>({x}, lane);\n"
         f"    scatter_round<4, 1>({x}, lane);\n"
         f"    {x}[0] += __shfl_xor_sync(kFull, {x}[0], 2);\n"
         f"    {x}[0] += __shfl_xor_sync(kFull, {x}[0], 1);\n",
         f"    {x}[0] += " + " + ".join(f"{x}[{i}]" for i in range(1, 8))
         + ";\n") for x in ("dvp", "dfg"))),
    ("no recompute", (("    advance(s - t0, kc);\n  };", "  };"),)),
    ("no pass 1", (("      for (int u = 0; u < kG; ++u) advance(t - t0 + u, "
                    "kg[u]);\n", ""),)),
    ("no sends", (("    st_async_pairs<R>(", "    if (cl > 16) st_async_pairs<R>("),
                  ("    if ((lane & 3) == 0 && s < hi)\n      st_async(",
                   "    if (cl > 16 && s < hi)\n      st_async("),
                  ("                    : 4u * (hi - lo) * (2 * D + (rank == 0 ? cl * W "
                   ": 0)));", "                    : 0u);"))),
)


def cluster_variant(src: str, cl: int) -> str:
    """The walk built for clusters of ``cl`` blocks, taking the plan the
    wrapper passes (whose shared bytes are those of 2), at dk = 512 (the
    other head dims need not divide into such clusters); the caller
    sizes the scratch for ``cl``."""
    edits = [("constexpr int kCluster = 2;",
              f"constexpr int kCluster = {cl};"),
             ("static_assert(kBlocks % kCluster == 0",
              "static_assert((D < 512 || kBlocks % kCluster == 0)"),
             ("static_assert(P::kBytes <= kMaxDynamic",
              "static_assert(D < 512 || P::kBytes <= kMaxDynamic"),
             ("cluster == kCluster && shared_bytes == P::kBytes;",
              "cluster > 0 && shared_bytes > 0;")]
    if cl > 8:
        edits.append(("        kMaxDynamic));\n  return rc;",
                      "        kMaxDynamic));\n  if (!rc)\n    rc = "
                      "static_cast<int>(cudaFuncSetAttribute(mlstm_bwd_walk<D>,"
                      " cudaFuncAttributeNonPortableClusterSizeAllowed, 1));"
                      "\n  return rc;"))
    return variant(src, (tuple(edits),))


def build_variants(build, kx, parts: Path, sources: dict) -> dict:
    """K9-bwd built from each of ``sources`` (name: text), the nvcc runs
    in parallel: name -> the loaded library."""
    procs = {}
    for k, (name, text) in enumerate(sources.items()):
        cu = parts / f"variant{k}.cu"
        cu.write_text(text)
        path = parts / f"libvariant{k}.so"
        procs[name] = (path, subprocess.Popen(
            [build._nvcc(), *build._flags("mlstm_scan_bwd"), "-o", str(path),
             str(cu)], stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
    libs = {}
    for name, (path, p) in procs.items():
        if p.wait():
            raise RuntimeError(f"nvcc failed for the variant {name!r}")
        lib = libs[name] = ctypes.CDLL(str(path))
        for fn, argtypes in kx._MLSTM_BWD_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
    return libs


def device_ms(torch, fn, key: str, calls: int = 10) -> float:
    """The device time a call of ``fn``'s CUDA kernels whose names hold
    ``key`` (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if key in e.key:
            t = getattr(e, "device_time_total", None)
            us += e.cuda_time_total if t is None else t
    return us / calls / 1e3


def variant(src: str, edit_sets) -> str:
    for edits in edit_sets:
        if all(src.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                src = src.replace(old, new)
            return src
    raise ValueError("no edit of the walk back applies to this source")


def timed(torch, fn, calls: int = 5, repeats: int = 3):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = []
    for _ in range(repeats):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return out


def measure(root: Path, quick: bool = False) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import xlstm_scan as kx

    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    out = {"root": str(root), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), "ms": {}, "device_ms": {}}
    build.build_all(("mlstm_scan", "mlstm_scan_bwd"))
    args = {}
    for label, (B, S, H, D) in SHAPES.items():
        q, k, v, dh = (normal(B, S, H, D) for _ in range(4))
        log_i = normal(B, S, H)
        log_f = ref.logsigmoid(normal(B, S, H) + 2.0)
        gates = (q, k, v, log_i, log_f)
        states = kx.mlstm_scan_fwd(*gates, with_states=True)
        args[label] = gates + states + (dh,)
        out["ms"][f"K9 {label}"] = timed(
            torch, lambda: kx.mlstm_scan_fwd(*gates))
        out["ms"][f"K9-bwd {label}"] = timed(
            torch, lambda: kx.mlstm_scan_bwd(*args[label]))
        out["device_ms"][f"K9 {label}"] = device_ms(
            torch, lambda: kx.mlstm_scan_fwd(*gates), "mlstm_scan_kernel")
        out["device_ms"][f"K9-bwd {label}"] = device_ms(
            torch, lambda: kx.mlstm_scan_bwd(*args[label]), "mlstm_bwd")
        print(f"  {label} {(B, S, H, D)}: K9 {out['ms'][f'K9 {label}']} ms"
              f" (device {out['device_ms'][f'K9 {label}']}), K9-bwd "
              f"{out['ms'][f'K9-bwd {label}']} ms (device "
              f"{out['device_ms'][f'K9-bwd {label}']})", flush=True)

    if quick:
        return out

    # 2. K9-bwd (x1) by launch
    from torch.profiler import ProfilerActivity, profile
    x1 = args["x1"]
    kx.mlstm_scan_bwd(*x1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kx.mlstm_scan_bwd(*x1)
        torch.cuda.synchronize()
    out["launch_ms"] = {}
    for e in prof.key_averages():
        if "mlstm_bwd" in e.key:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            name = re.search(r"mlstm_bwd_\w+", e.key).group(0)
            out["launch_ms"][name] = us / 3e3
    print(f"  K9-bwd (x1) by launch, ms a call: {out['launch_ms']}",
          flush=True)

    # 3. the walk without its walk back
    parts = REPO / "build" / "mlstm_parts" / str(abs(hash(str(root))))
    parts.mkdir(parents=True, exist_ok=True)
    for path in build.sources("mlstm_scan_bwd")[1:]:
        (parts / path.name).write_text(path.read_text())
    cu = parts / "mlstm_scan_bwd.cu"
    cu.write_text(variant((build.CSRC / "mlstm_scan_bwd.cu").read_text(),
                          NO_WALK_BACK))
    lib_path = parts / "libnowalkback.so"
    subprocess.run([build._nvcc(), *build._flags("mlstm_scan_bwd"), "-o",
                    str(lib_path), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in kx._MLSTM_BWD_SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    kept = build._LIBS["mlstm_scan_bwd"]
    build._LIBS["mlstm_scan_bwd"] = lib
    try:
        out["ms"]["K9-bwd x1, no walk back"] = timed(
            torch, lambda: kx.mlstm_scan_bwd(*x1))
    finally:
        build._LIBS["mlstm_scan_bwd"] = kept
    print(f"  K9-bwd (x1) without the walk back: "
          f"{out['ms']['K9-bwd x1, no walk back']} ms", flush=True)

    # 5. (below) clock stamps of the new kernels' stages
    if "cluster.sync();  // every block" in (
            build.CSRC / "mlstm_scan_bwd.cu").read_text():
        out["cycles"] = {}
        for name, stamps, start, call in (
                ("mlstm_scan_bwd", WALK_STAMPS, WALK_START,
                 lambda: kx.mlstm_scan_bwd(*x1)),
                ("mlstm_scan", FWD_STAMPS, FWD_START,
                 lambda: kx.mlstm_scan_fwd(*x1[:5]))):
            cu = parts / f"{name}.cu"
            cu.write_text(stamped((build.CSRC / f"{name}.cu").read_text(),
                                  stamps, start))
            lib_path = parts / f"lib{name}_stamped.so"
            subprocess.run([build._nvcc(), *build._flags(name), "-o",
                            str(lib_path), str(cu)], check=True,
                           capture_output=True)
            lib = ctypes.CDLL(str(lib_path))
            sigs = (kx._MLSTM_BWD_SIGNATURES if name == "mlstm_scan_bwd"
                    else kx._MLSTM_SIGNATURES)
            for fn, argtypes in sigs.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            kept = build._LIBS[name]
            build._LIBS[name] = lib
            try:
                call()
                torch.cuda.synchronize()
            finally:
                build._LIBS[name] = kept
            acc = (ctypes.c_longlong * 8)()
            lib.read_stamps.argtypes = [ctypes.c_void_p]
            build.check_launch(lib.read_stamps(ctypes.addressof(acc)),
                               "stamps")
            out["cycles"][name] = {st: acc[k] for k, st in enumerate(
                dict.fromkeys(st for _, st in stamps))}
            print(f"  {name} (x1) thread 0 of block 0, cycles a stage over "
                  f"the call: {out['cycles'][name]}", flush=True)

    # 6. (below) the walk with one part taken out; 4. its cluster sizes
    src = (build.CSRC / "mlstm_scan_bwd.cu").read_text()
    if "constexpr int kCluster = 2;" in src:
        sizes = (1, 2, 4, 8, 16)
        libs = build_variants(build, kx, parts, {
            **{name: variant(src, (edits,)) for name, edits in WALK_PARTS},
            **{cl: cluster_variant(src, cl) for cl in sizes}})
        out["walk_parts_ms"], out["clusters"] = {}, {}
        kept = build._LIBS["mlstm_scan_bwd"], kx.mlstm_bwd_scratch_floats
        for name, lib in libs.items():
            build._LIBS["mlstm_scan_bwd"] = lib
            if name in sizes:  # the partial sums of dk / 8 / name clusters
                kx.mlstm_bwd_scratch_floats = (
                    lambda B, S, H, dk, cl=name:
                    B * H * (dk // 8 // cl) * S * (2 * dk + 1) + 7 * B * S * H)
            try:
                ms = timed(torch, lambda: kx.mlstm_scan_bwd(*x1))
                if name in sizes:
                    out["clusters"][name] = dict(
                        resident=kx.mlstm_resident_clusters(512), ms=ms)
                else:
                    out["walk_parts_ms"][name] = ms
            finally:
                build._LIBS["mlstm_scan_bwd"] = kept[0]
                kx.mlstm_bwd_scratch_floats = kept[1]
            if name in sizes:
                print(f"  K9-bwd (x1), clusters of {name}: "
                      f"{out['clusters'][name]}", flush=True)
            else:
                print(f"  K9-bwd (x1), {name}: {out['walk_parts_ms'][name]}"
                      f" ms", flush=True)
    return out


def main(argv) -> int:
    quick = argv[:1] == ["--quick"]
    if quick:
        argv = argv[1:]
    if argv[:1] == ["--of"]:
        print(json.dumps(measure(Path(argv[1]).resolve(), quick)))
        return 0
    for root in argv or [str(REPO)]:
        print(f"{root}:", flush=True)
        p = subprocess.run([sys.executable, __file__]
                           + ["--quick"] * quick + ["--of", root],
                           timeout=900)
        if p.returncode:
            return p.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
