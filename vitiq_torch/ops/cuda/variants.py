"""Design experiments on K3's two attention passes, on the card.

Each experiment is a set of variants of `csrc/` (text edits of
`fused_layer_train.cu`), each built by its own nvcc into its own library
under ``build/variants/`` beside the package, with the sources as they are
("base") built the same way. Their C entries
(`vitiq_train_attention_{fwd,bwd}_recompute`) are timed in turns at B=4096
(CUDA events, 20 launches after 3, two rounds in opposite orders) on the
same inputs, and each build is checked against the plain versions on 64
frames (relative L2 of attn and dqkv; a variant that drops work fails that
by design: its times say what the dropped work cost). Each line names the
card and its power limit.

    python -m vitiq_torch.ops.cuda.variants [experiment ...]   # default: all

An edit that no longer matches the source raises: the experiments describe
the sources as they are. Needs nvcc and a CUDA card.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import time

import torch

from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.cuda import fused_layer_train as flt

SOURCE = "fused_layer_train.cu"
WORK = _build.BUILD_DIR.parent / "variants"
B = 4096

# (name, L, D, H): K3's training shapes and two more group counts
SHAPES = {"vit": (129, 128, 8), "rawiq_best": (65, 256, 8), "vit_tpu_production": (129, 128, 2),
          "rawiq (VITIQ_TRAIN_STASH=0)": (65, 128, 8), "vit_tiny_2016": (17, 64, 4),
          "L33": (33, 128, 4), "L129 d_head 32": (129, 128, 4)}

_ROUTE_FWD = "  if (recompute_fwd_wgmma(s.L, s.dh())) return rc_fwd(s, qkv, out, stats, st);"
_ROUTE_BWD = ("  if (recompute_wgmma(s.L)) return rc_bwd(s, qkv, attn, dattn, stats, dqkv, part, "
              "st);")
_PHASE2 = ("    for (int q0 = 0; q0 < L; q0 += WG_T) {\n"
           "      const int r_lo = q0 + 16 * warp + g, r_hi = r_lo + 8;\n"
           "      const bool live = q0 + 16 * warp < L;\n"
           "      uint32_t da[DH / 16][4];")

# experiment -> (shapes, {variant: [(old text, new text), ...]})
EXPERIMENTS = {
    # the mma.sync passes (train_attention_fwd / _bwd) in place of the wgmma ones, and the
    # wgmma forward at the ViT flagship's shape, which the routing leaves out
    "routing": (("vit", "rawiq_best", "vit_tpu_production", "rawiq (VITIQ_TRAIN_STASH=0)"), {
        "mma.sync passes": [(_ROUTE_FWD, ""), (_ROUTE_BWD, "")],
        "wgmma forward at d_head 16, NG 9": [
            ("constexpr bool rc_fwd_built(int dh, int ng) { return !(dh == 16 && ng == 9); }",
             "constexpr bool rc_fwd_built(int dh, int ng) { return true; }")]}),
    # fewer blocks an SM: 40,000 bytes more shared memory a backward block
    "occupancy": (("vit", "rawiq_best"), {
        "backward with 40000 more bytes of shared memory": [
            ("      const size_t smem = rc_bwd_smem_bytes(s.L, DH);",
             "      const size_t smem = rc_bwd_smem_bytes(s.L, DH) + 40000;")]}),
    # the backward's warpgroups a block at NG 9: one everywhere, or three at
    # d_head 16 too
    "warpgroups": (("vit", "vit_tpu_production", "L129 d_head 32"), {
        "one warpgroup at NG 9": [("  return ng == 9 && dh > 16 ? 3 : 1;", "  return 1;")],
        "three warpgroups at NG 9, d_head 16 too": [
            ("  return ng == 9 && dh > 16 ? 3 : 1;", "  return ng == 9 ? 3 : 1;"),
            ("  return ng == 9 ? (dh == 16 ? 3 : dh == 32 ? 2 : 1) : dh == 16 ? 6 : 1;",
             "  return ng == 9 ? (dh < 64 ? 2 : 1) : dh == 16 ? 6 : 1;")]}),
    # the backward's phases, each dropped (wrong results by design)
    "phases": (("vit", "rawiq_best"), {
        "no pbar arithmetic": [
            ("      tile_pbar<NGW>(s, pl, CHUNK, r_lo, key0, L, t, lo.x, hi.x, lo.y, hi.y);",
             "      *reinterpret_cast<uint32_t*>(pl + plane_off(r_lo, key0 + 2 * t, CHUNK)) =\n"
             "          __float_as_uint(s[0][0] + s[NGW - 1][7] + lo.x + hi.y);")],
        "no dV": [("    tile_t_rows_chunks<DH, N_K>(pl_a, CHUNK, wg, N_KC, WGS, dos_a, "
                   "out_base, 16 * warp + g, L,\n                                row3, 2 * D, "
                   "1.f, cs);", "")],
        "no dP, dS, dQ": [(_PHASE2, _PHASE2.replace("q0 < L;", "q0 < 0;"))],
        "no dK": [("    tile_t_rows_chunks<DH, N_K>(pl_a, CHUNK, wg, N_KC, WGS, qs_a, "
                   "out_base, 16 * warp + g, L,\n                                row3, D, "
                   "dk_scale, cs);", "")],
        "loads, q scaling and row terms only": [
            ("  // pbar into the plane, per query tile over the plane's R rows: warps with",
             "  if (L > 0) {\n    store_column_sums<DH, 4 * WGS>(red, part + (long long)b * row3 "
             "+ h * DH, D);\n    return;\n  }\n"
             "  // pbar into the plane, per query tile over the plane's R rows: warps with")]}),
    # pbar's quotient from p y alone, without the IEEE quotient (not exact)
    "quotient": (("vit", "rawiq_best"), {
        "p y alone": [
            ("          div_pair(pack_bf16x2(p0, p1), hi ? l_hi : l_lo, hi ? y_hi : y_lo);",
             "          pack_bf16x2(__bfloat162float(__float2bfloat16(p0)) * (hi ? y_hi : y_lo),"
             "\n                      __bfloat162float(__float2bfloat16(p1)) * "
             "(hi ? y_hi : y_lo));")]}),
    # the scores and dP in 16-key products, not one product of up to 64 keys
    "wide": (("vit", "vit_tpu_production", "L33"), {
        "16-key products": [("  if constexpr (NG >= 2 && NG <= 4) {",
                             "  if constexpr (false) {")]}),
    # no register bound for one warpgroup at d_head 16
    "min_blocks": (("vit", "rawiq (VITIQ_TRAIN_STASH=0)", "vit_tiny_2016"), {
        "no register bound at d_head 16": [
            ("  return ng == 9 ? (dh == 16 ? 3 : dh == 32 ? 2 : 1) : dh == 16 ? 6 : 1;",
             "  return ng == 9 ? (dh == 32 ? 2 : 1) : 1;")]}),
}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _sources(tag: str, index: int, edits) -> str:
    """A copy of csrc/ under WORK/v<index> with `edits` applied to SOURCE; its
    path."""
    d = WORK / f"v{index}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    text = (d / SOURCE).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{tag}: the edit's text occurs {text.count(old)} times in {SOURCE}: "
                             f"{old[:80]!r}")
        text = text.replace(old, new)
    (d / SOURCE).write_text(text)
    return str(d / SOURCE)


def build_all(variants: dict) -> dict:
    """Build each variant (tag -> edits) with its own nvcc, all at once; load
    each library. Returns tag -> (library, ptxas report)."""
    procs = {}
    for index, (tag, edits) in enumerate(variants.items()):
        src = _sources(tag, index, edits)
        lib = WORK / f"v{index}" / "lib.so"
        procs[tag] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                                             str(lib), src], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for tag, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag}: nvcc failed\n{report[-4000:]}")
        lib.with_name("ptxas.txt").write_text(report)
        dll = ctypes.CDLL(str(lib))
        for entry, n in (("vitiq_train_attention_fwd_recompute", 3),
                         ("vitiq_train_attention_bwd_recompute", 6)):
            getattr(dll, entry).argtypes = [ctypes.c_void_p] * n + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
        dll.vitiq_train_attention_recompute_blocks.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        out[tag] = (dll, report)
    return out


def _ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


def time_shape(name: str, libs: dict, card: str) -> None:
    """Each library's passes at one shape: times in two rounds (the second in
    the opposite order), blocks an SM, and errors against the plain
    versions on the first 64 frames."""
    L, D, H = SHAPES[name]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(L + D + H)
    qkv = torch.randn((B, L, 3 * D), generator=gen).to(dev, torch.bfloat16)
    dattn = (0.1 * torch.randn((B, L, D), generator=gen)).to(dev, torch.bfloat16)
    attn = torch.empty((B, L, D), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((B, H, L, 2), dtype=torch.float32, device=dev)
    dqkv, part = torch.empty_like(qkv), torch.empty((B, 3 * D), dtype=torch.float32, device=dev)
    want_attn, want_stats = flt.recompute_attention_fwd_plain(qkv[:64], H)
    want_dqkv, _ = flt.recompute_attention_bwd_plain(qkv[:64], want_attn, dattn[:64], want_stats,
                                                     H)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(dll, n=B):
        return dll.vitiq_train_attention_fwd_recompute(qkv.data_ptr(), attn.data_ptr(),
                                                       stats.data_ptr(), n, L, D, H, stream)

    def bwd(dll, n=B):
        return dll.vitiq_train_attention_bwd_recompute(
            qkv.data_ptr(), attn.data_ptr(), dattn.data_ptr(), stats.data_ptr(), dqkv.data_ptr(),
            part.data_ptr(), n, L, D, H, stream)

    times = {tag: [] for tag in libs}
    for order in (list(libs), list(libs)[::-1]):
        for tag in order:
            dll = libs[tag][0]
            if fwd(dll) or bwd(dll):
                raise RuntimeError(f"{tag}: a C entry failed at {name}")
            times[tag].append((_ms(lambda: fwd(dll)), _ms(lambda: bwd(dll))))
    for tag, (dll, _) in libs.items():
        fwd(dll, 64)
        torch.cuda.synchronize()
        err_attn, got_stats = _rel(attn[:64], want_attn), stats[:64].clone()
        attn[:64] = want_attn
        stats[:64] = want_stats
        bwd(dll, 64)
        torch.cuda.synchronize()
        blocks = (ctypes.c_int * 2)()
        dll.vitiq_train_attention_recompute_blocks(L, D, H, ctypes.addressof(blocks))
        print(f"  {name} (L={L} D={D} H={H}, B={B}) {tag}: fwd "
              f"{' / '.join(f'{f:.4f}' for f, _ in times[tag])} ms, bwd "
              f"{' / '.join(f'{b:.4f}' for _, b in times[tag])} ms; blocks an SM fwd {blocks[0]}, "
              f"bwd {blocks[1]}; relative L2 attn {err_attn:.2e}, stats "
              f"{_rel(got_stats, want_stats):.2e}, dqkv {_rel(dqkv[:64], want_dqkv):.2e}  [{card}]",
              flush=True)


def main(names) -> int:
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 1
    unknown = [n for n in names if n not in EXPERIMENTS]
    if unknown:
        print(f"variants: unknown experiment(s) {unknown}; have {list(EXPERIMENTS)}",
              file=sys.stderr)
        return 2
    names = names or list(EXPERIMENTS)
    card = _card()
    variants = {"base": []}
    for name in names:
        for tag, edits in EXPERIMENTS[name][1].items():
            variants[f"{name}: {tag}"] = edits
    t0 = time.perf_counter()
    libs = build_all(variants)
    print(f"variants: {len(libs)} builds of {SOURCE} in {time.perf_counter() - t0:.1f} s  "
          f"[{card}]", flush=True)
    for tag, (_, report) in libs.items():
        for kernel, (regs, stores, loads) in sorted(_build.ptxas_entries(report).items()):
            if "wg_recompute_attention" in kernel:
                print(f"  ptxas {tag}: {kernel.split('wg_recompute_attention_')[1][:24]}: {regs} "
                      f"registers, {stores + loads} bytes spilled", flush=True)
    for name in names:
        shapes, experiment = EXPERIMENTS[name]
        print(f"experiment {name}:", flush=True)
        chosen = {"base": libs["base"],
                  **{tag: libs[f"{name}: {tag}"] for tag in experiment}}
        for shape in shapes:
            time_shape(shape, chosen, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
