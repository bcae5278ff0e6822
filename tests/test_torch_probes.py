"""The port's probes (`vitiq_torch/probes/`) against the JAX package's TPU
probes under scripts/, run in Pallas interpret mode on the CPU.

Each TPU probe module is loaded from its file (`VITIQ_COMPILE_CACHE` pointed
at a temporary directory first, since the modules switch on JAX's persistent
compile cache when imported; the process's cache settings are restored
after), and its kernels run under `pltpu.force_tpu_interpret_mode()`. The
port's wrappers, given CPU tensors, run their plain versions; the same
seeded numpy inputs go to both.

* P1 (`tpu_probe_mask_ops.py`): the seven elementwise variants bit for bit
  (exp2 within `EXP2_ULPS`: two libraries' exp2), the four mm_* variants
  within `MM_RTOL` of the sum of the absolute products (f32 sums of exact
  bf16 products, taken in another order).
* P2 (`tpu_probe_refcost.py`): the three arms at batch 80, G 40, NR 4, their
  first operand perturbed by a seed, bit for bit; the reference's own
  defaults (batch 8192, G 40) fail its check that G divide the batch, and
  the port keeps that check.
* P3 (`tpu_probe_exp.py`: `kernel_noexp`): one layer at B=4, L=Lp=32, D=32,
  F=64, H=2 with vitiq's `encoder_layer_init` weights carried across by
  `encoder_layer_state_dict`; in f32 within 1e-4 relative L2 (it reads
  6.6e-7: f32 roundings, though a row's sum of scores can sit near zero),
  and run in bf16 as the probe runs it within `P3_BF16_REL` (below).
  L = Lp is the only shape where the two are the same function: the TPU
  probe adds -1e30 to padded keys' probabilities (not their scores), so its
  padded rows' v dominate its output, while the port has no padded rows.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vitiq.models.layers import encoder_layer_init
from vitiq_torch.interop import encoder_layer_state_dict
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.probes import exp, mask_ops, refcost
from vitiq_torch.probes._timing import time_amortized

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
_CACHE_OPTIONS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                  "jax_persistent_cache_min_entry_size_bytes")
# P3 run in bf16 as the TPU probe runs it (bf16 x, qkv and weight matrices):
# the two packages round q at different points (the port's q carries the
# softmax scale before its bf16 rounding), so each score, probability and
# the bf16 products after them differ by bf16 roundings (2^-8 relative)
# through five stages, and a denominator near zero magnifies them for its
# row: it reads 9.2e-3 relative L2 at this shape, held within 3e-2.
P3_BF16_REL = 3e-2


@pytest.fixture(scope="module")
def tpu_probes(tmp_path_factory, monkeypatch_module):
    """The three TPU probe modules, loaded from scripts/."""
    monkeypatch_module.setenv("VITIQ_COMPILE_CACHE", str(tmp_path_factory.mktemp("jax_cache")))
    saved = {name: getattr(jax.config, name) for name in _CACHE_OPTIONS}
    modules = {}
    try:
        for name in ("tpu_probe_mask_ops", "tpu_probe_refcost", "tpu_probe_exp"):
            spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            modules[name] = module
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
    return modules


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _interpret():
    return pltpu.force_tpu_interpret_mode()


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _run_pallas(kernel, args, out_shape):
    specs = [pl.BlockSpec(a.shape, lambda: (0,) * a.ndim, memory_space=pltpu.VMEM)
             for a in args]
    out_spec = pl.BlockSpec(out_shape, lambda: (0,) * len(out_shape), memory_space=pltpu.VMEM)
    with _interpret():
        out = pl.pallas_call(kernel, in_specs=specs, out_specs=out_spec,
                             out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32))(*args)
    return np.asarray(out)


@pytest.mark.parametrize("name", mask_ops.VARIANTS)
def test_mask_op_matches_tpu_probe(tpu_probes, name):
    probe = tpu_probes["tpu_probe_mask_ops"]
    assert (probe.G, probe.LP, probe.T, probe.SEQ, probe.C0) == (
        mask_ops.G, mask_ops.LP, mask_ops.T, mask_ops.SEQ, mask_ops.C0)
    x = _normal(0, (mask_ops.G, mask_ops.LP, mask_ops.T))
    want = _run_pallas(probe.KS[name], [jnp.asarray(x)], x.shape)
    got = mask_ops.mask_op(name, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if name == "exp2":
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert np.isfinite(got).all() and ulps.max() <= mask_ops.EXP2_ULPS
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", mask_ops.MM_VARIANTS)
def test_mm_mask_matches_tpu_probe(tpu_probes, name):
    probe = tpu_probes["tpu_probe_mask_ops"]
    ks = {"mm_plain": probe.k_mm_plain, "mm_add_splat": probe.k_mm_add_splat,
          "mm_add_select": probe.k_mm_add_select, "mm_add_clip": probe.k_mm_add_clip}
    x = _normal(0, (mask_ops.G, mask_ops.LP, mask_ops.K))
    w = _normal(1, (mask_ops.G, mask_ops.T, mask_ops.K))
    want = _run_pallas(ks[name], [jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)],
                       (mask_ops.G, mask_ops.LP, mask_ops.T))
    xt, wt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    got = mask_ops.mm_mask(name, xt, wt).numpy()
    scale = torch.matmul(xt.float().abs(), wt.float().abs().mT).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all(np.abs(got - want) <= mask_ops.MM_RTOL * scale)
    if name in ("mm_add_select", "mm_add_clip"):  # the masked columns exactly
        np.testing.assert_array_equal(got[..., 1:], want[..., 1:])


def test_mask_op_inputs_are_the_probes():
    args = mask_ops.inputs("cpu")
    np.testing.assert_array_equal(args["x"].numpy(), _normal(0, (8, 144, 16)))
    assert args["xm"].dtype == torch.bfloat16 and tuple(args["w"].shape) == (8, 16, 32)
    for name in mask_ops.VARIANTS + mask_ops.MM_VARIANTS:
        assert not mask_ops.disagreement(name, mask_ops.run(name, args),
                                         mask_ops.reference(name, args), args)
    with pytest.raises(ValueError, match="unknown variant"):
        mask_ops.mask_op("iota_wide", args["x"])


@pytest.mark.parametrize("tag", ["many", "mid", "fat"])
def test_refcost_arm_matches_tpu_probe(tpu_probes, tag):
    probe = tpu_probes["tpu_probe_refcost"]
    batch, g, nr = 80, 40, 4
    _, nrefs, width = {t: (t, n, w) for t, n, w in refcost.arms(nr)}[tag]
    xs = [_normal(10 + i, (batch, refcost.LP, width)) for i in range(nrefs)]
    with _interpret():
        want = jax.jit(probe.make_call(nrefs, width, batch, g))(
            jnp.float32(3.0), *(jnp.asarray(x, jnp.bfloat16) for x in xs))
    want = [want] if nrefs == 1 else list(want)
    got = refcost.make_call(nrefs, width, batch, g)(
        torch.tensor(3.0), *(torch.from_numpy(x).to(torch.bfloat16) for x in xs))
    got = [got] if nrefs == 1 else list(got)
    assert len(got) == len(want) == nrefs
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)))


def test_refcost_keeps_the_reference_checks():
    with pytest.raises(ValueError, match=r"batch \(8192\) must be a multiple of G \(40\)"):
        refcost.main([])  # the reference's own defaults
    with pytest.raises(ValueError, match="NR must be a multiple of 4"):
        refcost.measure(8200, 40, 6)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        refcost.measure(8200, 40, 16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        time_amortized(lambda seed, x: x, (torch.zeros(2),))


def _noexp_layer_jax(probe, tree, x, dtype):
    """The TPU probe's kernel_noexp on one layer, as its main builds the
    operands (the matrices in `dtype`), in interpret mode."""
    B, Lp, D = x.shape
    n_head = 2
    ap = tree["attention"]
    mat = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    args = [mat(jnp.concatenate([ap[k]["kernel"] for k in ("w_q", "w_k", "w_v")], axis=1)),
            jnp.concatenate([ap[k]["bias"] for k in ("w_q", "w_k", "w_v")]),
            mat(ap["w_concat"]["kernel"]), ap["w_concat"]["bias"],
            tree["norm1"]["gamma"], tree["norm1"]["beta"],
            mat(tree["ffn"]["linear1"]["kernel"]), tree["ffn"]["linear1"]["bias"],
            mat(tree["ffn"]["linear2"]["kernel"]), tree["ffn"]["linear2"]["bias"],
            tree["norm2"]["gamma"], tree["norm2"]["beta"]]
    G = 2
    kernel = functools.partial(probe.kernel_noexp, seq_len=Lp, n_head=n_head,
                               scale=1.0 / np.sqrt(D // n_head))
    data = pl.BlockSpec((G, Lp, D), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    rep = lambda s: pl.BlockSpec(s, lambda i: (0,) * len(s), memory_space=pltpu.VMEM)  # noqa: E731
    with _interpret():
        out = pl.pallas_call(
            kernel, grid=(B // G,), in_specs=[data] + [rep(a.shape) for a in args],
            out_specs=data, out_shape=jax.ShapeDtypeStruct((B, Lp, D), x.dtype),
            scratch_shapes=[pltpu.VMEM((G, Lp, D), x.dtype)])(x, *args)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noexp_layer_matches_tpu_probe(tpu_probes, dtype):
    probe = tpu_probes["tpu_probe_exp"]
    B, Lx, D, F, H = 4, 32, 32, 64, 2
    tree = encoder_layer_init(jax.random.PRNGKey(3), D, F)
    layer = EncoderLayer(D, F, H)
    layer.load_state_dict(encoder_layer_state_dict(tree))
    x = _normal(5, (B, Lx, D))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _noexp_layer_jax(probe, tree, jnp.asarray(x, jdt), jdt)
    ops = fel.layer_operands(layer.eval(), H, tdt)
    got = exp.fused_encoder_layer_noexp(torch.from_numpy(x).to(tdt), ops, H).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= (1e-4 if dtype == "float32" else P3_BF16_REL)


def test_noexp_reference_is_the_function_written_out():
    """The plain core equals the no-exp function written out, and its row
    max enters the arithmetic as (s - m) + m."""
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 17, 3 * 32), generator=gen)
    got = exp.attention_noexp_reference(qkv, 2, 17)
    q, k, v = (qkv[..., i * 32:(i + 1) * 32].reshape(2, 17, 2, 16).transpose(1, 2)
               for i in range(3))
    s = q @ k.mT
    want = ((s @ v) / s.sum(-1, keepdim=True)).transpose(1, 2).reshape(2, 17, 32)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    ops = exp.stack_operands(1, 32, 128, 2, "cpu", dtype=torch.float32)[0]
    x = torch.randn((2, 17, 32), generator=gen)
    torch.testing.assert_close(exp.fused_encoder_layer_noexp(x, ops, 2),
                               exp.fused_layer_noexp_reference(x, ops, 2), rtol=0, atol=0)


# The gates that hold P3 to its plain version on the card (`exp.check_core`,
# `exp.check_layer`), checked here on plain outputs and copies of them
# broken on purpose: each gate passes the plain version, rejects a broken
# core or layer, and leaves out only the rows whose sum of scores is small
# beside its magnitudes.

def _qkv():
    qkv = torch.randn((4, 40, 3 * 64), generator=torch.Generator().manual_seed(7))
    return qkv.to(torch.bfloat16)


def test_attention_noexp_runs_its_plain_version_on_the_cpu():
    qkv = _qkv()
    exp.reset_launches()
    assert torch.equal(exp.attention_noexp(qkv, 2), exp.attention_noexp_reference(qkv, 2, 40))
    assert exp.launches == {"fused_encoder_layer_noexp": 0, "attention_noexp": 0}
    ops = exp.stack_operands(1, 64, 128, 2, "cpu")[0]
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        exp.check_core(qkv, 2)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        exp.check_layer(qkv[..., :64].contiguous(), ops, 2, all_rows=True)


@pytest.mark.parametrize("mutation", ["last_key_tile_dropped", "heads_swapped",
                                      "one_held_row_2pc_off"])
def test_core_gate_rejects_a_broken_core(mutation):
    qkv = _qkv()
    cond = exp.conditioning(qkv, 2)
    want = exp.attention_noexp_reference(qkv, 2, 40)
    plain = exp.core_readings(want, want, cond)
    assert plain["row_rel_held"] == 0.0 and plain["finite"] and plain["held"] > 0.5
    if mutation == "last_key_tile_dropped":  # zero k and v rows add exactly 0 to both sums
        broken = qkv.clone()
        broken[:, 32:, 64:] = 0
        got = exp.attention_noexp_reference(broken, 2, 40)
    elif mutation == "heads_swapped":
        got = want.reshape(4, 40, 2, 32).flip(2).reshape(4, 40, 64)
    else:
        b, h, i = np.unravel_index(int(cond.argmax()), tuple(cond.shape))
        got = want.float()
        got[b, i, h * 32:(h + 1) * 32] *= 1.02
    assert exp.core_readings(got, want, cond)["row_rel_held"] > exp.CORE_ROW_REL


def test_core_gate_leaves_out_rows_whose_sum_of_scores_nears_zero():
    qkv = _qkv()
    cond = exp.conditioning(qkv, 2)
    assert float(cond.min()) < exp.COND_FLOOR
    want = exp.attention_noexp_reference(qkv, 2, 40)
    b, h, i = np.unravel_index(int(cond.argmin()), tuple(cond.shape))
    got = want.clone()
    got[b, i, h * 32:(h + 1) * 32] *= -1
    r = exp.core_readings(got, want, cond)
    assert r["row_rel_held"] == 0.0 and r["rel"] > 0.0


def test_layer_gate_holds_the_rows_held_in_every_head():
    B, Lx, D, F, H = 4, 40, 64, 128, 2
    ops = exp.stack_operands(1, D, F, H, "cpu", seed=3)[0]
    x = torch.randn((B, Lx, D), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    want = exp.fused_layer_noexp_reference(x, ops, H)
    cond = exp.conditioning((fel._mm(x, ops[0]) + ops[1]).to(torch.bfloat16), H)
    plain = exp.layer_readings(want, want, cond)
    assert plain["rel"] == plain["rel_held"] == plain["max_abs"] == 0.0
    worst = cond.amin(dim=1)  # [B, L]: the least conditioning over the heads
    assert 0.3 < plain["held"] < 1.0 and float(worst.min()) < exp.COND_FLOOR
    b, i = np.unravel_index(int(worst.argmin()), tuple(worst.shape))
    got = want.clone()
    got[b, i] *= -1
    r = exp.layer_readings(got, want, cond)
    assert r["rel_held"] == 0.0 and r["rel"] > exp.LAYER_REL
    assert r["worst_row_rel"] == pytest.approx(2.0) and r["worst_row_cond"] < exp.COND_FLOOR
    b, i = np.unravel_index(int(worst.argmax()), tuple(worst.shape))
    got = want.float()
    got[b, i] *= 1.5
    assert exp.layer_readings(got, want, cond)["rel_held"] > exp.LAYER_REL
