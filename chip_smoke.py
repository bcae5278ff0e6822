#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vitiq_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each of
which raises (exit code 1) on failure:

1. device: a CUDA GPU must be present; the card's name and power limit.
2. build: the kernels of `vitiq_torch/csrc/*.cu` are compiled with nvcc for
   sm_90a and loaded.
3. kernels: K1 (full fused layers) and K2 (the CLS-row layer) on the GPU
   against their plain PyTorch version on the GPU, on the same bf16 inputs
   and seeded random weights, at the ViT flagship (L=129, F=512) and rawIQ
   flagship (L=65, F=1024) shapes, B=256, D=128, H=8: each of five K1
   layers and the K2 layer on the plain version's input to it
   (|kernel - plain| <= 3e-2 + 1.6e-2 * |plain|), and the five K1 layers as
   one stack (6e-2 + 3.2e-2 * |plain|); see LAYER_TOL and STACK_TOL.
4. serve: the ViT flagship (d128/L6/H8, bf16 `tpu` numerics, seeded random
   weights) answers ragged requests of 1, 37, 256 and 1000 raw [B, 1024, 2]
   frames through `Server` with buckets (256, 1024). Every launch counter is
   reset just before and read just after: K1 must have launched once per full
   layer and K2 once per request. Logits are checked against the same
   weights on the f32 `reference` path on the GPU: max |dlogit| < 0.05 and
   argmax agreement >= 0.99 on rows whose reference top-2 margin exceeds
   4 * max |dlogit|. The rawIQ flagship (seg-16, FFN 1024) repeats the check.
5. timing (CUDA events after warm-up): per-layer kernel time against the
   plain version at B=4096, and serving frames/s and p50 latency at B=4096
   for both flagships, beside the card's name and power limit.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from vitiq_torch.config import DataConfig, ExperimentConfig
from vitiq_torch.config import flagship_rawiq_config, flagship_vit_config
from vitiq_torch.models import AMCModel
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.serve import Server, build_serving_fn

# (atol, rtol) on bf16 outputs, |kernel - plain| <= atol + rtol * |plain|.
# One layer on the same input: about two bf16 ulps (2^-7 relative each) plus
# an absolute floor near zero -- the two sum in different orders, so bf16
# roundings may flip. A stack of layers: twice that, since each layer's flips
# feed the next one's input.
LAYER_TOL = (3e-2, 1.6e-2)
STACK_TOL = (6e-2, 3.2e-2)
LOGIT_GATE, AGREE_GATE = 0.05, 0.99
STATS = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
FRAME_LEN = 1024
SOURCE = "vitiq_torch/csrc/fused_encoder_layer.cu"
TPU_SOURCE = "vitiq/ops/pallas/fused_encoder_layer.py"
DEVICE = torch.device("cuda", 0)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def random_layers(n_layers: int, ffn: int, seed: int, device):
    gen = torch.Generator().manual_seed(seed)
    layers = [EncoderLayer(128, ffn, 8, device=device, generator=gen).eval()
              for _ in range(n_layers)]
    with torch.no_grad():  # LayerNorm affine away from (1, 0)
        for layer in layers:
            for norm in (layer.norm1, layer.norm2):
                norm.gamma.copy_(1.0 + 0.1 * torch.randn(128, generator=gen))
                norm.beta.copy_(0.1 * torch.randn(128, generator=gen))
    return layers


def check_close(label: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    atol, rtol = tol
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    err = (got - want).abs()
    max_abs = err.max().item()
    excess = (err - (atol + rtol * want.abs())).max().item()
    print(f"  {label}: max |kernel - plain| = {max_abs:.6g}, mean {err.mean().item():.6g} "
          f"(max excess over {atol} + {rtol}*|plain|: {excess:.6g})", flush=True)
    if excess > 0:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return max_abs


def check_kernels(device) -> dict:
    """Each K1 layer and the K2 layer on the same input as the plain version
    (the plain output of the layer before), then the 5-layer K1 stack end to
    end. Returns the largest per-layer difference of each kernel."""
    print("phase kernels: kernel vs plain version on the GPU, B=256", flush=True)
    errs = {"k1": 0.0, "k2": 0.0}
    gen = torch.Generator().manual_seed(7)
    for name, L, ffn in (("vit", 129, 512), ("rawiq", 65, 1024)):
        layers = random_layers(6, ffn, seed=11 if name == "vit" else 12, device=device)
        ops = [fel.layer_operands(layer, 8) for layer in layers]
        x = torch.randn((256, L, 128), generator=gen).to(device, torch.bfloat16)
        with torch.no_grad():
            h = x
            for i in range(5):
                got = fel.fused_encoder_layer(h, ops[i], 8)
                want = fel.fused_layer_reference(h, ops[i], 8, L)
                torch.cuda.synchronize()
                errs["k1"] = max(errs["k1"], check_close(
                    f"{name} K1 layer {i} (L={L}, F={ffn})", got, want, LAYER_TOL))
                h = want
            stack = fel.fused_encoder_layer_stack(x, layers[:5], 8)
            torch.cuda.synchronize()
            check_close(f"{name} K1 5-layer stack", stack, h, STACK_TOL)
            got = fel.fused_encoder_layer_cls(h, ops[5], 8)
            want = fel.fused_layer_reference(h, ops[5], 8, 1)
            torch.cuda.synchronize()
            errs["k2"] = max(errs["k2"], check_close(
                f"{name} K2 CLS layer (L={L}, F={ffn})", got, want, LAYER_TOL))
    return errs


def serve_check(label: str, model_cfg, device, sizes, buckets) -> dict:
    """Serve ragged requests through the kernels; compare with the f32 path."""
    n_full = model_cfg.n_layers - 1
    exp = ExperimentConfig(model=model_cfg, data=DataConfig(synthetic_frame_len=FRAME_LEN))
    model = AMCModel(model_cfg, generator=torch.Generator().manual_seed(0))
    ref_cfg = ExperimentConfig(model=dataclasses.replace(model_cfg, numerics="reference"),
                               data=exp.data)
    ref_model = AMCModel(ref_cfg.model)
    ref_model.load_state_dict(model.state_dict())
    server = Server(build_serving_fn(exp, model, STATS, device), FRAME_LEN, buckets, device)
    ref_serve = build_serving_fn(ref_cfg, ref_model, STATS, device)
    gen = torch.Generator().manual_seed(1)
    requests = [torch.randn((n, FRAME_LEN, 2), generator=gen).to(device) for n in sizes]

    fel.reset_launches()
    outs = []
    for x in requests:
        before = dict(fel.launches)
        outs.append(server.run(x))
        torch.cuda.synchronize()
        k1 = fel.launches["fused_encoder_layer"] - before["fused_encoder_layer"]
        k2 = fel.launches["fused_encoder_layer_cls"] - before["fused_encoder_layer_cls"]
        if (k1, k2) != (n_full, 1):
            raise AssertionError(f"{label}: request of {x.shape[0]} launched K1 {k1}x and "
                                 f"K2 {k2}x, expected {n_full}x and 1x")
    counts = dict(fel.launches)

    got = torch.cat(outs)
    want = torch.cat([ref_serve(x) for x in requests])
    torch.cuda.synchronize()
    if got.shape != (sum(sizes), model_cfg.num_classes) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad logits {tuple(got.shape)}")
    max_abs = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    confident = (top2[:, 0] - top2[:, 1]) > 4 * max_abs
    agree = (got.argmax(-1) == want.argmax(-1)).float()
    agree_conf = agree[confident].mean().item() if confident.any() else 1.0
    print(f"  {label}: requests {list(sizes)} via buckets {list(buckets)}; launches "
          f"K1 {counts['fused_encoder_layer']}, K2 {counts['fused_encoder_layer_cls']}; "
          f"max |dlogit| vs f32 path {max_abs:.6g}; argmax agreement "
          f"{agree.mean().item():.4f} (confident rows: {agree_conf:.4f} over "
          f"{int(confident.sum())})", flush=True)
    if not max_abs < LOGIT_GATE:
        raise AssertionError(f"{label}: bf16 logits diverge from the f32 path")
    if agree_conf < AGREE_GATE:
        raise AssertionError(f"{label}: argmax diverges on confident rows")
    return {"counts": counts, "max_abs": max_abs, "model": model, "exp": exp}


def time_serving(label: str, serve, batch: int, device, card: str, iters: int = 20) -> None:
    x = torch.randn((batch, FRAME_LEN, 2), generator=torch.Generator().manual_seed(2)).to(device)
    for _ in range(3):
        serve(x)
    torch.cuda.synchronize()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        serve(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    ms = cuda_ms(lambda: serve(x), iters, warmup=0)
    p50 = statistics.median(lat) * 1e3
    print(f"  {label} serving B={batch}: p50 latency {p50:.4f} ms (host clock, synced), "
          f"{batch / (ms / 1e3):.1f} frames/s (CUDA events, {ms:.4f} ms/batch)  [{card}]",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    device = DEVICE
    card = card_line()
    print(f"phase device: {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()}); nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    print("phase build:", flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)} {[s.name for s in _build.sources()]} -> "
          f"{lib.relative_to(_build.BUILD_DIR.parents[1])} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    errs = check_kernels(device)

    print("phase serve: ragged requests through Server, bf16 kernels vs f32 path", flush=True)
    vit = serve_check("vit flagship", flagship_vit_config("tpu"), device,
                      (1, 37, 256, 1000), (256, 1024))
    rawiq = serve_check("rawiq flagship", flagship_rawiq_config("tpu"), device,
                        (1, 37, 256, 1000), (256, 1024))

    print(f"phase timing (CUDA events after warm-up) on {card}:", flush=True)
    times = {}
    for name, L, ffn in (("vit", 129, 512), ("rawiq", 65, 1024)):
        ops = fel.layer_operands(random_layers(1, ffn, seed=13, device=device)[0], 8)
        x = torch.randn((4096, L, 128), generator=torch.Generator().manual_seed(3))
        x = x.to(device, torch.bfloat16)
        with torch.no_grad():
            t = {
                "k1_ms": cuda_ms(lambda: fel.fused_encoder_layer(x, ops, 8), 20),
                "k1_plain_ms": cuda_ms(lambda: fel.fused_layer_reference(x, ops, 8, L), 10),
                "k2_ms": cuda_ms(lambda: fel.fused_encoder_layer_cls(x, ops, 8), 20),
                "k2_plain_ms": cuda_ms(lambda: fel.fused_layer_reference(x, ops, 8, 1), 10),
            }
        times[name] = t
        print(f"  {name} layer B=4096 L={L} F={ffn}: K1 {t['k1_ms']:.4f} ms vs plain "
              f"{t['k1_plain_ms']:.4f} ms; K2 {t['k2_ms']:.4f} ms vs plain "
              f"{t['k2_plain_ms']:.4f} ms  [{card}]", flush=True)
    for label, res in (("vit flagship", vit), ("rawiq flagship", rawiq)):
        serve = build_serving_fn(res["exp"], res["model"], STATS, device)
        time_serving(label + " (kernels)", serve, 4096, device, card)
        os.environ["VITIQ_NO_FUSED_LAYER"] = "1"
        try:
            time_serving(label + " (plain layer loop, VITIQ_NO_FUSED_LAYER=1)", serve, 4096,
                         device, card)
        finally:
            del os.environ["VITIQ_NO_FUSED_LAYER"]

    counts = vit["counts"]
    kernels = [
        {"name": "fused_encoder_layer (K1, full layers)", "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_SOURCE}:717", "launches": counts["fused_encoder_layer"],
         "max_abs_err": errs["k1"], "ms": times["vit"]["k1_ms"],
         "plain_ms": times["vit"]["k1_plain_ms"]},
        {"name": "fused_encoder_layer_cls (K2, CLS row)", "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_SOURCE}:920", "launches": counts["fused_encoder_layer_cls"],
         "max_abs_err": errs["k2"], "ms": times["vit"]["k2_ms"],
         "plain_ms": times["vit"]["k2_plain_ms"]},
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
