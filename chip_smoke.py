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
   4 * max |dlogit|. The rawIQ flagship (seg-16, FFN 1024) repeats the check
   with non-trivial stats (RAW_STATS) through `build_forward_and_preprocess`,
   which gives it the fused raw embedding (raw frames straight into one
   GEMM), as the JAX package serves it; its f32 path keeps the unfused chain.
5. train-kernels: K3-fwd and K3-bwd (the fused training layer, recompute
   regime) on the GPU against their plain PyTorch versions at the ViT
   flagship shape (B=256, L=129, F=512, H=8, dropout 0.1) and the rawIQ one
   (B=256, L=65, F=1024, H=8, dropout 0.2), then K4-fwd and K4-bwd (the
   stash regime) at the rawIQ shape: the forward, dx and K4's bf16 stash
   tensors within LAYER_TOL, K4's f32 1/std within 1e-3 relative, each of
   the 12 weight, bias and LN gradients within GRAD_REL of the plain
   gradient in the L2 norm (max |difference| printed). K4-bwd runs on the
   plain version's stash, so that it alone is under test.
6. train: the ViT flagship and the rawIQ flagship (bf16 `tpu` numerics,
   seeded random weights) each take 20 `make_train_step` steps at B=256 on
   one repeated random batch at lr 1e-3, the rawIQ one on raw frames through
   the fused raw embedding. The launch counters are reset just before each
   step and read just after: every ViT step must launch K3-fwd and K3-bwd
   once per layer (6 each) and K4 never; every rawIQ step K4-fwd and K4-bwd
   6 times each and K3 never, the regimes the JAX package's stash gate picks
   (Lp 144 and 80). The loss must stay finite and end below where it
   started. One step's gradient at dropout 0 from the same weights is held
   against the plain bf16 layers (VITIQ_FUSED_TRAIN=0, cosine >= 0.999) and
   the f32 `reference` path (cosine >= 0.995).
7. timing (CUDA events after warm-up): per-layer kernel time against the
   plain version at B=4096 (K1, K2 and K3 at both flagship shapes, K4 at
   the rawIQ one), serving frames/s and p50 latency at B=4096 for both
   flagships, and train-step frames/s and peak device memory at B=4096: the
   ViT flagship through K3 and through the plain layers, the rawIQ flagship
   through K4, through K3 (VITIQ_TRAIN_STASH=0) and through the plain
   layers, beside the card's name and power limit.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from vitiq_torch.config import DataConfig, ExperimentConfig, TrainConfig
from vitiq_torch.config import flagship_rawiq_config, flagship_vit_config
from vitiq_torch.models import AMCModel
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.ops.cuda import fused_layer_train as flt
from vitiq_torch.ops.metrics import label_smoothed_cross_entropy
from vitiq_torch.serve import Server, build_forward_and_preprocess, build_serving_fn
from vitiq_torch.train import make_train_step
from vitiq_torch.train.optim import create_train_state, make_optimizer

# (atol, rtol) on bf16 outputs, |kernel - plain| <= atol + rtol * |plain|.
# One layer on the same input: about two bf16 ulps (2^-7 relative each) plus
# an absolute floor near zero -- the two sum in different orders, so bf16
# roundings may flip. A stack of layers: twice that, since each layer's flips
# feed the next one's input.
LAYER_TOL = (3e-2, 1.6e-2)
STACK_TOL = (6e-2, 3.2e-2)
LOGIT_GATE, AGREE_GATE = 0.05, 0.99
# K3-bwd's gradients are sums over B*L rows taken in another order than the
# plain version's, from operands whose bf16 roundings may flip: each within
# 1% of the plain gradient in the L2 norm.
GRAD_REL = 1e-2
COSINE_PLAIN, COSINE_F32 = 0.999, 0.995
TRAIN_DROP, TRAIN_SEED = 0.1, 1234
STATS = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
RAW_STATS = {"i_mean": 0.1, "i_std": 1.3, "q_mean": -0.2, "q_std": 0.9}
RAW_DROP = 0.2  # the rawIQ flagship's dropout
K3 = ("fused_train_layer_fwd", "fused_train_layer_bwd")
K4 = ("fused_train_layer_fwd_stash", "fused_train_layer_bwd_stash")
GRAD_NAMES = ("dWqkv", "dbqkv", "dWo", "dbo", "dg1", "dbe1", "dW1", "db1", "dW2", "db2", "dg2",
              "dbe2")
FRAME_LEN = 1024
SOURCE = "vitiq_torch/csrc/fused_encoder_layer.cu"
TPU_SOURCE = "vitiq/ops/pallas/fused_encoder_layer.py"
TRAIN_SOURCE = "vitiq_torch/csrc/fused_layer_train.cu"
TRAIN_TPU_SOURCE = "vitiq/ops/pallas/fused_layer_train.py"
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


def serve_check(label: str, model_cfg, stats, device, sizes, buckets) -> dict:
    """Serve ragged requests through the kernels; compare with the f32 path."""
    n_full = model_cfg.n_layers - 1
    exp = ExperimentConfig(model=model_cfg, data=DataConfig(synthetic_frame_len=FRAME_LEN))
    model = AMCModel(model_cfg, generator=torch.Generator().manual_seed(0))
    ref_cfg = ExperimentConfig(model=dataclasses.replace(model_cfg, numerics="reference"),
                               data=exp.data)
    ref_model = AMCModel(ref_cfg.model)
    ref_model.load_state_dict(model.state_dict())
    server = Server(build_serving_fn(exp, model, stats, device), FRAME_LEN, buckets, device)
    ref_serve = build_serving_fn(ref_cfg, ref_model, stats, device)
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
    front = "fused raw embedding" if model.raw_stats is not None else "preprocess + embedding"
    print(f"  {label}: requests {list(sizes)} via buckets {list(buckets)} ({front}); launches "
          f"K1 {counts['fused_encoder_layer']}, K2 {counts['fused_encoder_layer_cls']}; "
          f"max |dlogit| vs f32 path {max_abs:.6g}; argmax agreement "
          f"{agree.mean().item():.4f} (confident rows: {agree_conf:.4f} over "
          f"{int(confident.sum())})", flush=True)
    if not max_abs < LOGIT_GATE:
        raise AssertionError(f"{label}: bf16 logits diverge from the f32 path")
    if agree_conf < AGREE_GATE:
        raise AssertionError(f"{label}: argmax diverges on confident rows")
    return {"counts": counts, "max_abs": max_abs, "model": model, "exp": exp, "stats": stats,
            "raw_embed": model.raw_stats is not None}


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


def train_operands(ffn: int, seed: int, device):
    layer = random_layers(1, ffn, seed, device)[0]
    return [t.detach().contiguous() for t in flt.flat_weights(layer, torch.bfloat16)]


def check_grads(label: str, grads, want) -> float:
    """Each gradient within GRAD_REL of the plain one in the L2 norm; returns
    the largest max |difference|."""
    worst = 0.0
    for name, got, ref in zip(GRAD_NAMES, grads, want):
        got, ref = got.float(), ref.float()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{label} {name}: bad gradient {tuple(got.shape)}")
        rel = ((got - ref).norm() / ref.norm()).item()
        max_abs = (got - ref).abs().max().item()
        worst = max(worst, max_abs)
        print(f"  {label} {name}: ||kernel - plain|| / ||plain|| = {rel:.6g} (limit {GRAD_REL}), "
              f"max |kernel - plain| = {max_abs:.6g}, max |plain| = {ref.abs().max().item():.6g}",
              flush=True)
        if not rel <= GRAD_REL:
            raise AssertionError(f"{label} {name}: kernel gradient disagrees with the plain one")
    return worst


def check_train_kernels(device) -> dict:
    """K3-fwd and K3-bwd against their plain versions at both flagship
    shapes, then K4-fwd and K4-bwd at the rawIQ one, dropout on. Returns the
    largest difference of each kernel."""
    errs = {"k3f": 0.0, "k3b": 0.0}
    gen = torch.Generator().manual_seed(8)
    for name, L, ffn, drop in (("vit", 129, 512, TRAIN_DROP), ("rawiq", 65, 1024, RAW_DROP)):
        print(f"phase train-kernels: K3 vs plain version on the GPU, {name} shape B=256 L={L} "
              f"F={ffn} H=8, dropout {drop}", flush=True)
        ops = train_operands(ffn, 21, device)
        x = torch.randn((256, L, 128), generator=gen).to(device, torch.bfloat16)
        dy = (0.05 * torch.randn((256, L, 128), generator=gen)).to(device, torch.bfloat16)
        args = (8, drop, TRAIN_SEED, 3)
        with torch.no_grad():
            y = flt.fused_train_layer_fwd(x, ops, *args)
            want = flt.fused_train_layer_reference(x, ops, *args)
            torch.cuda.synchronize()
            errs["k3f"] = max(errs["k3f"], check_close(f"{name} K3-fwd", y, want, LAYER_TOL))
            dx, grads = flt.fused_train_layer_bwd(x, dy, ops, *args)
            want_dx, want_grads = flt.fused_train_layer_backward_reference(x, dy, ops, *args)
            torch.cuda.synchronize()
        errs["k3b"] = max(errs["k3b"], check_close(f"{name} K3-bwd dx", dx, want_dx, LAYER_TOL),
                          check_grads(f"{name} K3-bwd", grads, want_grads))

    print(f"phase train-kernels: K4 vs plain version on the GPU, rawiq shape B=256 L=65 F=1024 "
          f"H=8, dropout {RAW_DROP}", flush=True)
    # x, dy, ops and args are the rawiq shape's, the last of the loop above
    with torch.no_grad():
        y, stash = flt.fused_train_layer_fwd_stash(x, ops, *args)
        want, want_stash = flt.fused_train_layer_stash_reference(x, ops, *args)
        torch.cuda.synchronize()
        k4f = check_close("K4-fwd y", y, want, LAYER_TOL)
        for name, got, ref in zip(("attn", "xh1", "xh2", "r1", "r2", "pbar"), stash, want_stash):
            if got.dtype != ref.dtype:
                raise AssertionError(f"K4-fwd {name}: dtype {got.dtype} != {ref.dtype}")
            tol = (0.0, 1e-3) if name in ("r1", "r2") else LAYER_TOL
            k4f = max(k4f, check_close(f"K4-fwd stash {name}", got, ref, tol))
        dx, grads = flt.fused_train_layer_bwd_stash(x, dy, want_stash, ops, *args)
        want_dx, want_grads = flt.fused_train_layer_stash_backward_reference(x, dy, want_stash,
                                                                             ops, *args)
        torch.cuda.synchronize()
    k4b = max(check_close("K4-bwd dx", dx, want_dx, LAYER_TOL),
              check_grads("K4-bwd", grads, want_grads))
    return {**errs, "k4f": k4f, "k4b": k4b}


def flat_grad(model, inputs, labels, seed) -> torch.Tensor:
    """The gradient of one training step's loss, flat in f32."""
    model.train()
    gen = torch.Generator(device=inputs.device).manual_seed(0)
    loss = label_smoothed_cross_entropy(model(inputs, generator=gen, seed=seed), labels, 0.1)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return torch.cat([g.reshape(-1).float() for g in grads])


def train_experiment(cfg, batch: int) -> ExperimentConfig:
    return ExperimentConfig(model=cfg, data=DataConfig(synthetic_frame_len=FRAME_LEN),
                            train=TrainConfig(batch_size=batch, learning_rate=1e-3))


def train_check(label: str, cfg, stats, kernels, device) -> dict:
    """20 train steps of a flagship through the training kernels `kernels`
    (K3 or K4, the other never launching), then the gradient of one
    dropout-free step against the plain bf16 and the f32 paths. The model
    and its preprocess come from `build_forward_and_preprocess`, so the
    rawIQ flagship takes raw frames through the fused raw embedding."""
    print(f"phase train: {label}, 20 make_train_step steps, B=256, lr 1e-3", flush=True)
    exp = train_experiment(cfg, 256)
    model, pre = build_forward_and_preprocess(
        exp, AMCModel(cfg, generator=torch.Generator().manual_seed(0)), stats)
    model.to(device)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(5)
    frames = torch.randn((256, FRAME_LEN, 2), generator=gen).to(device)
    labels = torch.randint(0, cfg.num_classes, (256,), generator=gen).to(device)
    step = make_train_step(make_optimizer(exp.train), exp.train.label_smoothing, pre)
    state = create_train_state(model, exp.train)
    n = cfg.n_layers
    others = K4 if kernels == K3 else K3
    want = {kernels[0]: n, kernels[1]: n, others[0]: 0, others[1]: 0}

    counts = {k: 0 for k in flt.launches}
    losses = []
    for i in range(20):
        flt.reset_launches()
        state, metrics = step(state, frames, labels, exp.train.dropout_seed)
        losses.append(float(metrics["loss"]))
        got = dict(flt.launches)
        if got != want:
            raise AssertionError(f"{label} train step {i} launched {got}, expected {want}")
        counts = {k: counts[k] + got[k] for k in counts}
    print(f"  launches over 20 steps: {counts}; loss step 1 {losses[0]:.6g}, step 10 "
          f"{losses[9]:.6g}, step 20 {losses[-1]:.6g}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses[0]} -> {losses[-1]}")

    cfg0 = dataclasses.replace(cfg, drop_prob=0.0)
    fused, pre0 = build_forward_and_preprocess(train_experiment(cfg0, 256), cfg0, stats)
    fused.to(device).load_state_dict(init)
    inputs = pre0(frames)
    flt.reset_launches()
    g_fused = flat_grad(fused, inputs, labels, TRAIN_SEED)
    if flt.launches[kernels[1]] != n:
        raise AssertionError(f"the dropout-free step did not run {kernels[1]}")
    os.environ["VITIQ_FUSED_TRAIN"] = "0"
    try:
        g_plain = flat_grad(fused, inputs, labels, TRAIN_SEED)
    finally:
        del os.environ["VITIQ_FUSED_TRAIN"]
    ref_cfg = dataclasses.replace(cfg0, numerics="reference")
    ref, ref_pre = build_forward_and_preprocess(train_experiment(ref_cfg, 256), ref_cfg, stats)
    ref.to(device).load_state_dict(init)
    g_ref = flat_grad(ref, ref_pre(frames), labels, TRAIN_SEED)
    cos_plain = torch.nn.functional.cosine_similarity(g_fused, g_plain, dim=0).item()
    cos_f32 = torch.nn.functional.cosine_similarity(g_fused, g_ref, dim=0).item()
    print(f"  gradient cosine at dropout 0: vs plain bf16 layers {cos_plain:.6f} (limit "
          f"{COSINE_PLAIN}), vs f32 reference path {cos_f32:.6f} (limit {COSINE_F32})",
          flush=True)
    if not cos_plain >= COSINE_PLAIN or not cos_f32 >= COSINE_F32:
        raise AssertionError(f"{label}: fused training gradients diverge from the plain paths")
    return {"counts": counts, "stats": stats}


def time_train_step(label: str, cfg, stats, batch: int, device, card: str, iters: int,
                    env=None) -> float:
    """ms per `make_train_step` step at `batch` (CUDA events after two warm-up
    steps) and the step's peak device memory, with `env` set around it."""
    os.environ.update(env or {})
    try:
        exp = train_experiment(cfg, batch)
        model, pre = build_forward_and_preprocess(exp, cfg, stats)
        model.to(device)
        gen = torch.Generator().manual_seed(6)
        frames = torch.randn((batch, FRAME_LEN, 2), generator=gen).to(device)
        labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen).to(device)
        step = make_train_step(make_optimizer(exp.train), exp.train.label_smoothing, pre)
        box = [create_train_state(model, exp.train)]

        def one():
            box[0] = step(box[0], frames, labels, exp.train.dropout_seed)[0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(one, iters, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        for key in env or {}:
            del os.environ[key]
    print(f"  {label} train step B={batch}: {ms:.4f} ms/step, {batch / (ms / 1e3):.1f} frames/s "
          f"(CUDA events); peak device memory {peak:.3f} GiB  [{card}]", flush=True)
    del box, model
    torch.cuda.empty_cache()
    return ms


def time_train_layers(label: str, L: int, ffn: int, drop: float, device, card: str,
                      stash: bool) -> dict:
    """K3 (and with `stash` K4) against their plain versions on one layer at
    B=4096."""
    ops = train_operands(ffn, 13, device)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((4096, L, 128), generator=gen).to(device, torch.bfloat16)
    dy = (0.05 * torch.randn((4096, L, 128), generator=gen)).to(device, torch.bfloat16)
    args = (8, drop, TRAIN_SEED, 0)
    with torch.no_grad():
        t = {
            "k3f_ms": cuda_ms(lambda: flt.fused_train_layer_fwd(x, ops, *args), 10),
            "k3f_plain_ms": cuda_ms(lambda: flt.fused_train_layer_reference(x, ops, *args), 3,
                                    warmup=1),
            "k3b_ms": cuda_ms(lambda: flt.fused_train_layer_bwd(x, dy, ops, *args), 10),
            "k3b_plain_ms": cuda_ms(
                lambda: flt.fused_train_layer_backward_reference(x, dy, ops, *args), 3, warmup=1),
        }
        line = (f"  {label} train layer B=4096 L={L} F={ffn} dropout {drop}: K3-fwd "
                f"{t['k3f_ms']:.4f} ms vs plain {t['k3f_plain_ms']:.4f} ms; K3-bwd "
                f"{t['k3b_ms']:.4f} ms vs plain {t['k3b_plain_ms']:.4f} ms")
        if stash:
            _, st = flt.fused_train_layer_fwd_stash(x, ops, *args)
            t.update({
                "k4f_ms": cuda_ms(lambda: flt.fused_train_layer_fwd_stash(x, ops, *args), 10),
                "k4f_plain_ms": cuda_ms(
                    lambda: flt.fused_train_layer_stash_reference(x, ops, *args), 3, warmup=1),
                "k4b_ms": cuda_ms(lambda: flt.fused_train_layer_bwd_stash(x, dy, st, ops, *args),
                                  10),
                "k4b_plain_ms": cuda_ms(lambda: flt.fused_train_layer_stash_backward_reference(
                    x, dy, st, ops, *args), 3, warmup=1),
            })
            line += (f"; K4-fwd {t['k4f_ms']:.4f} ms vs plain {t['k4f_plain_ms']:.4f} ms; K4-bwd "
                     f"{t['k4b_ms']:.4f} ms vs plain {t['k4b_plain_ms']:.4f} ms")
            del st
    print(line + f"  [{card}]", flush=True)
    del x, dy
    torch.cuda.empty_cache()
    return t


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
    vit = serve_check("vit flagship", flagship_vit_config("tpu"), STATS, device,
                      (1, 37, 256, 1000), (256, 1024))
    rawiq = serve_check("rawiq flagship", flagship_rawiq_config("tpu"), RAW_STATS, device,
                        (1, 37, 256, 1000), (256, 1024))
    if vit["raw_embed"] or not rawiq["raw_embed"]:
        raise AssertionError("the fused raw embedding must serve the rawIQ flagship only")

    train_errs = check_train_kernels(device)
    vit_train = train_check("ViT flagship", flagship_vit_config("tpu"), STATS, K3, device)
    raw_train = train_check("rawIQ flagship", flagship_rawiq_config("tpu"), RAW_STATS, K4, device)

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
    del x
    times["vit"].update(time_train_layers("vit", 129, 512, TRAIN_DROP, device, card, False))
    times["rawiq"].update(time_train_layers("rawiq", 65, 1024, RAW_DROP, device, card, True))

    vit_cfg, raw_cfg = flagship_vit_config("tpu"), flagship_rawiq_config("tpu")
    time_train_step("vit flagship (K3 kernels)", vit_cfg, STATS, 4096, device, card, 5)
    time_train_step("vit flagship (plain layers, VITIQ_FUSED_TRAIN=0)", vit_cfg, STATS, 4096,
                    device, card, 3, {"VITIQ_FUSED_TRAIN": "0"})
    time_train_step("rawiq flagship (K4 kernels)", raw_cfg, RAW_STATS, 4096, device, card, 5)
    time_train_step("rawiq flagship (K3 kernels, VITIQ_TRAIN_STASH=0)", raw_cfg, RAW_STATS, 4096,
                    device, card, 5, {"VITIQ_TRAIN_STASH": "0"})
    time_train_step("rawiq flagship (plain layers, VITIQ_FUSED_TRAIN=0)", raw_cfg, RAW_STATS,
                    4096, device, card, 3, {"VITIQ_FUSED_TRAIN": "0"})

    for label, res in (("vit flagship", vit), ("rawiq flagship", rawiq)):
        serve = build_serving_fn(res["exp"], res["model"], res["stats"], device)
        time_serving(label + " (kernels)", serve, 4096, device, card)
        os.environ["VITIQ_NO_FUSED_LAYER"] = "1"
        try:
            time_serving(label + " (plain layer loop, VITIQ_NO_FUSED_LAYER=1)", serve, 4096,
                         device, card)
        finally:
            del os.environ["VITIQ_NO_FUSED_LAYER"]

    counts, k3, k4 = vit["counts"], vit_train["counts"], raw_train["counts"]
    vt, rt = times["vit"], times["rawiq"]
    kernels = [
        {"name": "fused_encoder_layer (K1, full layers)", "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_SOURCE}:717", "launches": counts["fused_encoder_layer"],
         "max_abs_err": errs["k1"], "ms": vt["k1_ms"], "plain_ms": vt["k1_plain_ms"]},
        {"name": "fused_encoder_layer_cls (K2, CLS row)", "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_SOURCE}:920", "launches": counts["fused_encoder_layer_cls"],
         "max_abs_err": errs["k2"], "ms": vt["k2_ms"], "plain_ms": vt["k2_plain_ms"]},
        {"name": "fused_train_layer_fwd (K3-fwd)", "route": "cuda", "source": TRAIN_SOURCE,
         "replaces": f"{TRAIN_TPU_SOURCE}:417", "launches": k3["fused_train_layer_fwd"],
         "max_abs_err": train_errs["k3f"], "ms": vt["k3f_ms"], "plain_ms": vt["k3f_plain_ms"]},
        {"name": "fused_train_layer_bwd (K3-bwd)", "route": "cuda", "source": TRAIN_SOURCE,
         "replaces": f"{TRAIN_TPU_SOURCE}:674", "launches": k3["fused_train_layer_bwd"],
         "max_abs_err": train_errs["k3b"], "ms": vt["k3b_ms"], "plain_ms": vt["k3b_plain_ms"]},
        {"name": "fused_train_layer_fwd_stash (K4-fwd)", "route": "cuda", "source": TRAIN_SOURCE,
         "replaces": f"{TRAIN_TPU_SOURCE}:478", "launches": k4["fused_train_layer_fwd_stash"],
         "max_abs_err": train_errs["k4f"], "ms": rt["k4f_ms"], "plain_ms": rt["k4f_plain_ms"]},
        {"name": "fused_train_layer_bwd_stash (K4-bwd)", "route": "cuda", "source": TRAIN_SOURCE,
         "replaces": f"{TRAIN_TPU_SOURCE}:674", "launches": k4["fused_train_layer_bwd_stash"],
         "max_abs_err": train_errs["k4b"], "ms": rt["k4b_ms"], "plain_ms": rt["k4b_plain_ms"]},
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
