"""Where a step of the sLSTM scan kernels goes, on the card.

K10 (``csrc/slstm_scan.cu``) and K10-bwd (``csrc/slstm_scan_bwd.cu``) are
chains of S dependent steps, so their time is S times a step's latency.
This script splits that latency two ways at xlstm-350m's (B, S, H, dh) =
(1, 4096, 4, 256), on random inputs:

1. Variants, each the kernel with one part of its step taken out (their
   outputs are wrong on purpose), timed with CUDA events: the step's time
   less a variant's bounds what that part costs.  ``cluster_sync`` puts
   back the exchange the kernels first had, a store into each block's
   shared memory and one cluster barrier a step, in place of the
   st.async stores and mbarriers.
2. Clock stamps (``clock64``) of thread 0 of block 0 at the step's stages,
   median cycles over 64 steps.

Each variant is compiled from the kernel's source with one edit, into
``build/step_parts/``.  Needs the card and nvcc::

    PYTHONPATH=src python tools/slstm_step_parts.py
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import xlstm_scan as kx

OUT = build.BUILD_DIR.parent / "step_parts"
B, S, H, D = 1, 4096, 4, 256

STAMP = ("__device__ long long stamps[64][8];\n"
         "#define STAMP(K) if (threadIdx.x == 0 && blockIdx.x == 0 && "
         "t >= 2000 && t < 2064) stamps[t - 2000][K] = clock64();\n")
READ_STAMPS = ('\nextern "C" int read_stamps(void* host) {\n'
               "  return (int)cudaMemcpyFromSymbol(host, stamps, "
               "sizeof(stamps));\n}\n")


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"not found once: {old!r}")
    return src.replace(old, new)


def cut(src: str, first: str, last: str, new: str) -> str:
    """``src`` with the text from ``first`` to the end of ``last`` (the
    first after it) replaced by ``new``."""
    i = src.index(first)
    j = src.index(last, i) + len(last)
    return src[:i] + new + src[j:]


def forward_variants(src: str) -> dict:
    wait = "    if (t > 0) mbar_wait(&full[t & 1], ((t - 1) >> 1) & 1);\n"
    arm = ("    if (tid == 0 && t + 1 < seq_len) mbar_expect(&full[(t + 1) "
           "& 1], 4 * D);\n")
    store = "st_async(&hs[(t + 1) & 1][j], hv, &full[(t + 1) & 1], sub);"
    no_exchange = edit(edit(edit(src, wait, ""), arm, ""), store,
                       "hs[(t + 1) & 1][j] = hv;")
    cluster_sync = edit(
        no_exchange, "hs[(t + 1) & 1][j] = hv;\n    }\n",
        "cg::this_cluster().map_shared_rank(&hs[(t + 1) & 1][j], sub)[0] "
        "= hv;\n      cluster_barrier<P::kCluster>();\n    }\n")
    stamped = src.replace('#include "slstm_cluster.cuh"\n',
                          '#include "slstm_cluster.cuh"\n' + STAMP)
    for k, anchor in enumerate((
            "    const float x = xs[buf][g][tt][col];",
            "    const float4* h4 = reinterpret_cast",
            "    float hv = 0.0f;\n    if (cell) {",
            "    if (t + 1 < seq_len) {\n      hv = __shfl_sync",
            "    if (cell) {  // off the step's chain",
            "  }\n  cp_wait<0>();")):
        stamped = edit(stamped, anchor, f"    STAMP({k})\n" + anchor)
    return {
        "kernel": src,
        "no cell math": cut(src, "      const float z = tanhf(pz);",
                            "      hv = o_t * c / fmaxf(n, 1e-6f);\n",
                            "      hv = (pz + i_raw) + (f_raw + po);\n"),
        "no product": edit(src, "      const float4 hv = h4[P::kChunks * s "
                                "+ q];",
                           "      const float4 hv = make_float4(1e-3f, "
                           "2e-3f, 3e-3f, 4e-3f);"),
        "no exchange": no_exchange,
        "cluster_sync": cluster_sync,
        "stamped": stamped + READ_STAMPS,
    }


def backward_variants(src: str) -> dict:
    wait = ("      mbar_wait(&full[(t + 1) & 1], ((seq_len - 2 - t) >> 1) & "
            "1);\n")
    arm = "    if (tid == 0 && t > 0) mbar_expect(&full[t & 1], 16 * D);\n"
    store = "          st_async(&ds[t & 1][i], d, &full[t & 1], q);"
    stamped = src.replace('#include "slstm_cluster.cuh"\n',
                          '#include "slstm_cluster.cuh"\n' + STAMP)
    for k, anchor in enumerate((
            "    if (tid == 0 && t > 0) mbar_expect",
            "      const float4* d4 = ds[(t + 1) & 1] + split * kK;",
            "    if (tt == 0 && t > 0) cp_wait<0>();",
            "    // tile k - 1 into the buffer of tile k + 1",
            "      const float gt = tile[7][sl][col] + (g0 + g1);",
            "      if (t > 0)\n        for (int q = 0;",
            "      // off the step's chain: after the exchange",
            "  }\n  cp_wait<0>();")):
        stamped = edit(stamped, anchor, f"    STAMP({k})\n" + anchor)
    return {
        "kernel": src,
        "no chain through g_h": cut(
            src, "      const float gt = tile[7][sl][col] + (g0 + g1);",
            "d_o * o * (1.0f - o));\n",
            "      const float4 d = make_float4(g0 + g1 + z, o + c_now, "
            "ip + fp + N + share_n, ht + share + sig + c_before + "
            "n_before);\n"),
        "no product": edit(src, "        const float4 d = d4[s];",
                           "        const float4 d = make_float4(1e-3f, "
                           "2e-3f, 3e-3f, 4e-3f);"),
        "no exchange": edit(edit(edit(src, wait, ""), arm, ""), store,
                            "          ds[t & 1][i] = d;"),
        "stamped": stamped + READ_STAMPS,
    }


def compile_all(variants: dict) -> dict:
    """{(kernel, variant): library path}, one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "slstm_cluster.cuh").write_text(
        (build.CSRC / "slstm_cluster.cuh").read_text())
    procs = {}
    for n, (key, text) in enumerate(variants.items()):
        cu = OUT / f"v{n}.cu"
        cu.write_text(text)
        lib = OUT / f"libv{n}.so"
        procs[key] = (lib, subprocess.Popen(
            [build._nvcc(), *build._flags("slstm_scan"), "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for key, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        libs[key] = lib
    return libs


def main() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    xs = [normal(B, S, H, D) for _ in range(4)]
    rs = [normal(H, D, D, scale=0.02) for _ in range(4)]
    dh = normal(B, S, H, D)
    states = kx.slstm_scan_fwd(*xs, *rs, with_states=True)
    grads = [torch.empty(B, S, H, D, device="cuda") for _ in range(4)]
    h = torch.empty(B, S, H, D, device="cuda")
    plan = kx.slstm_plan(D)[:4]

    variants = {("K10", k): v for k, v in forward_variants(
        (build.CSRC / "slstm_scan.cu").read_text()).items()}
    variants.update({("K10-bwd", k): v for k, v in backward_variants(
        (build.CSRC / "slstm_scan_bwd.cu").read_text()).items()})
    libs = compile_all(variants)

    def launcher(key):
        lib = ctypes.CDLL(str(libs[key]))
        if key[0] == "K10":
            fn = lib.slstm_scan_f32
            fn.argtypes = list(kx._SLSTM_SIGNATURES["slstm_scan_f32"])
            args = [t.data_ptr() for t in xs + rs] + [
                h.data_ptr(), B, S, H, D, *plan, build.stream()]
        else:
            fn = lib.slstm_scan_bwd_f32
            fn.argtypes = list(
                kx._SLSTM_BWD_SIGNATURES["slstm_scan_bwd_f32"])
            args = [t.data_ptr() for t in rs + list(states[1:]) + [dh]
                    + grads] + [B, S, H, D, 1, *plan, build.stream()]
        return lib, lambda: build.check_launch(fn(*args), str(key))

    print(f"{torch.cuda.get_device_name(0)}; (B, S, H, dh) = "
          f"{(B, S, H, D)}; ms over 5 launches, twice")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for key in variants:
        if key[1] == "stamped":
            continue
        _, run = launcher(key)
        run()
        times = []
        for _ in range(2):
            start.record()
            for _ in range(5):
                run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 5)
        print(f"  {key[0]:8s} {key[1]:22s} "
              + ", ".join(f"{ms:.4f} ms ({ms * 1e3 / S:.4f} us a step)"
                          for ms in times))
    for kernel, stages in (("K10", 6), ("K10-bwd", 8)):
        lib, run = launcher((kernel, "stamped"))
        run()
        torch.cuda.synchronize()
        stamps = np.zeros((64, 8), np.int64)
        lib.read_stamps.argtypes = [ctypes.c_void_p]
        build.check_launch(lib.read_stamps(stamps.ctypes.data), "stamps")
        c = stamps[:, :stages].astype(np.float64)
        if kernel == "K10-bwd":
            c = c[::-1]  # its walk runs t down
        parts = [np.median(c[:, k + 1] - c[:, k]) for k in range(stages - 1)]
        parts.append(np.median(c[1:, 0] - c[:-1, stages - 1]))
        print(f"  {kernel} thread 0 of block 0, median cycles a step "
              f"{np.median(np.diff(c[:, 0])):.0f}: stages "
              + ", ".join(f"{p:.0f}" for p in parts))


if __name__ == "__main__":
    main()
