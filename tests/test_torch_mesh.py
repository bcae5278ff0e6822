"""The port's device mesh rules against vitiq's, with no processes started:
`make_mesh` / `make_multislice_mesh` shapes and errors, `process_local_rows`
on `tests/test_process_feed.py`'s geometries (the same fake process
mappings), `ProcessShardFeed`'s rows and its partial-batch errors, the
tensor-parallel split of every `state_dict` entry of both arms against
vitiq's `_spec_for` taken through the interop layout, the data rank's seed
fold, the column shard's dropout lanes, and the seedless training forward,
which raises in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitiq.config import ModelConfig as VModelConfig
from vitiq.data.feeds import ArrayFeed as VArrayFeed
from vitiq.data.feeds import ProcessShardFeed as VProcessShardFeed
from vitiq.models import init_amc_params, make_forward
from vitiq.parallel import mesh as vmesh
from vitiq_torch.config import ModelConfig
from vitiq_torch.data.feeds import ArrayFeed, DataFeed, ProcessShardFeed
from vitiq_torch.interop import state_dict_from_vitiq
from vitiq_torch.models import AMCModel
from vitiq_torch.models.encoder import fold_data_index
from vitiq_torch.ops.cuda import fused_layer_train as flt
from vitiq_torch.parallel import mesh as pmesh

RANKS = list(range(8))  # vitiq's 8-device virtual CPU mesh, as ranks


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [{}, {"data": 2, "model": 4}, {"data": 4, "model": 2},
                                {"model": 2}, {"data": 3}])
def test_make_mesh_shapes_match_vitiq(kw):
    v = vmesh.make_mesh(**kw)
    p = pmesh.make_mesh(devices=RANKS, **kw)
    assert p.axis_names == v.axis_names
    assert p.shape == dict(v.shape)
    assert pmesh.mesh_data_axes(p) == vmesh.mesh_data_axes(v)
    # the ranks lie where vitiq's virtual devices lie
    assert p.devices.tolist() == [[d.id for d in row] for row in np.asarray(v.devices)]


@pytest.mark.parametrize("kw", [{"dcn_data": 2, "model": 2}, {"dcn_data": 2},
                                {"dcn_data": 2, "ici_data": 2}, {"dcn_data": 4, "model": 2}])
def test_make_multislice_mesh_shapes_match_vitiq(kw):
    v = vmesh.make_multislice_mesh(**kw)
    p = pmesh.make_multislice_mesh(devices=RANKS, **kw)
    assert p.axis_names == v.axis_names == ("dcn_data", "data", "model")
    assert p.shape == dict(v.shape)
    assert pmesh.mesh_data_axes(p) == vmesh.mesh_data_axes(v)


@pytest.mark.parametrize("call", [
    ("make_mesh", {"data": 4, "model": 4}),
    ("make_mesh", {"data": 9}),
    ("make_multislice_mesh", {"dcn_data": 16}),
    ("make_multislice_mesh", {"dcn_data": 2, "ici_data": 4, "model": 2}),
])
def test_mesh_errors_match_vitiq(call):
    name, kw = call
    want = _error(lambda: getattr(vmesh, name)(**kw))
    assert _error(lambda: getattr(pmesh, name)(devices=RANKS, **kw)) == want


def _owners(v, p, owner_of_row):
    """The same fake device -> process mapping for vitiq's mesh (by device
    id) and the port's (by rank), each device by its row on the leading
    data axis (`tests/test_process_feed.py`'s helpers)."""
    vdev, pdev = np.asarray(v.devices), p.devices
    vown, pown = {}, {}
    for r in range(vdev.shape[0]):
        for vd, pd in zip(np.ravel(vdev[r]), np.ravel(pdev[r])):
            vown[vd.id] = pown[int(pd)] = owner_of_row(r, vdev.shape[0])
    return (lambda d: vown[d.id]), (lambda d: pown[d])


GEOMETRIES = {
    "dp4xtp2-halves": ("make_mesh", {"data": 4, "model": 2}, 16,
                       lambda r, n: 0 if r < n // 2 else 1),
    "dp4xtp2-first-row": ("make_mesh", {"data": 4, "model": 2}, 16,
                          lambda r, n: 0 if r == 0 else 1),
    "multislice-dcn2": ("make_multislice_mesh", {"dcn_data": 2, "model": 1}, 32,
                        lambda r, n: 0 if r < n // 2 else 1),
    "dp8-one-process": ("make_mesh", {"data": 8, "model": 1}, 24, lambda r, n: 0),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_process_local_rows_match_vitiq(name):
    fn, kw, batch, owner_of_row = GEOMETRIES[name]
    v, p = getattr(vmesh, fn)(**kw), getattr(pmesh, fn)(devices=RANKS, **kw)
    vown, pown = _owners(v, p, owner_of_row)
    for proc in sorted({pown(int(d)) for d in p.devices.flat}):
        want = vmesh.process_local_rows(v, batch, process_index=proc, process_of_device=vown)
        got = pmesh.process_local_rows(p, batch, process_index=proc, process_of_device=pown)
        assert (got.start, got.stop) == (want.start, want.stop)


def test_non_contiguous_rows_raise_as_in_vitiq():
    v, p = vmesh.make_mesh(data=4, model=2), pmesh.make_mesh(data=4, model=2, devices=RANKS)
    vown, pown = _owners(v, p, lambda r, n: r % 2)
    want = _error(lambda: vmesh.process_local_rows(v, 16, process_index=0,
                                                    process_of_device=vown))
    assert "non-contiguous" in want
    assert _error(lambda: pmesh.process_local_rows(p, 16, process_index=0,
                                                    process_of_device=pown)) == want


def test_each_rank_is_its_own_process_by_default():
    """Without a mapping every rank is a process: rank r holds the rows of
    its data index, its model-axis peers the same ones, as vitiq's
    batch_sharding places them on the devices."""
    v, p = vmesh.make_mesh(data=4, model=2), pmesh.make_mesh(data=4, model=2, devices=RANKS)
    imap = vmesh.batch_sharding(v).devices_indices_map((16,))
    for d, idx in imap.items():
        rows = pmesh.batch_sharding(p, 16, rank=d.id)
        assert (rows.start, rows.stop) == (idx[0].start, idx[0].stop)
    batch = (np.arange(16), np.arange(16) * 2)
    assert [a.tolist() for a in pmesh.shard_batch(batch, p, rank=5)] == [[8, 9, 10, 11],
                                                                          [16, 18, 20, 22]]
    assert "does not divide" in _error(lambda: pmesh.batch_sharding(p, 6, rank=0))


def test_process_shard_feed_yields_vitiq_rows():
    fn, kw, _, owner_of_row = GEOMETRIES["dp4xtp2-halves"]
    v, p = getattr(vmesh, fn)(**kw), getattr(pmesh, fn)(devices=RANKS, **kw)
    vown, pown = _owners(v, p, owner_of_row)
    x = np.arange(64, dtype=np.float32).reshape(64, 1)
    y = np.arange(64, dtype=np.int32)
    for proc in (0, 1):
        vf = VProcessShardFeed(VArrayFeed(x, y, shuffle_seed=3), v, process_index=proc,
                               process_of_device=vown)
        pf = ProcessShardFeed(ArrayFeed(x, y, shuffle_seed=3), p, process_index=proc,
                              process_of_device=pown)
        for (vx, vy), (px, py) in zip(vf.train_batches(2, 16), pf.train_batches(2, 16)):
            np.testing.assert_array_equal(px, vx)
            np.testing.assert_array_equal(py, vy)
        ex = np.ones((20, 2), np.float32)
        ey = np.zeros(20, np.int32)
        vf = VProcessShardFeed(VArrayFeed(ex, ey), v, process_index=proc, process_of_device=vown)
        pf = ProcessShardFeed(ArrayFeed(ex, ey), p, process_index=proc, process_of_device=pown)
        for vb, pb in zip(vf.eval_batches(16), pf.eval_batches(16)):
            for a, b in zip(vb, pb):
                np.testing.assert_array_equal(b, a)
        assert len(list(pf.raw_batches(16))) == 2  # global, the last batch partial


class _Ragged(DataFeed):
    """A feed whose batches come one row short."""

    num_samples = 30

    def train_batches(self, epoch, batch_size):
        yield np.zeros((batch_size - 1, 2), np.float32), np.zeros(batch_size - 1, np.int32)

    def eval_batches(self, batch_size):
        n = batch_size - 1
        yield np.zeros((n, 2), np.float32), np.zeros(n, np.int32), np.ones(n, np.float32)


@pytest.mark.parametrize("kind", ["train_batches", "eval_batches"])
def test_partial_batches_raise_vitiqs_errors(kind):
    v, p = vmesh.make_mesh(data=2, model=1), pmesh.make_mesh(data=2, model=1, devices=[0, 1])
    args = (0, 8) if kind == "train_batches" else (8,)
    want = _error(lambda: list(getattr(VProcessShardFeed(_Ragged(), v), kind)(*args)))
    got = _error(lambda: list(getattr(ProcessShardFeed(_Ragged(), p, process_index=0), kind)(
        *args)))
    assert "partial batch" in want and got == want


ARMS = {
    "vit": dict(arm="vit", num_classes=5, d_model=32, n_head=4, n_layers=2, ffn_hidden=64,
                img_size_h=16, img_size_w=16, patch_size=8),
    "rawiq": dict(arm="rawiq", num_classes=5, d_model=32, n_head=4, n_layers=2, ffn_hidden=64,
                  seq_length=64, segment_size=16),
    "rawiq-mean": dict(arm="rawiq", num_classes=5, d_model=32, n_head=4, n_layers=1,
                       ffn_hidden=64, seq_length=64, segment_size=16, use_cls_token=False),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_tp_rule_of_every_state_dict_entry_is_vitiqs(arm):
    """vitiq's TP spec of every leaf, marked as values that vary along the
    split axis only, taken through `state_dict_from_vitiq`: the torch entry
    varies along the dim the port's rule splits, and along none where it
    keeps the entry whole."""
    vcfg = VModelConfig(**ARMS[arm])
    params = init_amc_params(jax.random.PRNGKey(0), vcfg)
    specs = vmesh.param_shardings(vmesh.make_mesh(data=2, model=4), params)

    def marked(leaf, sharding):
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * leaf.ndim
        shape[axes[0]] = leaf.shape[axes[0]]
        ramp = np.arange(leaf.shape[axes[0]], dtype=np.float32).reshape(shape)
        return np.broadcast_to(ramp, leaf.shape).copy()

    tree = jax.tree_util.tree_map(marked, params, specs)
    sd = state_dict_from_vitiq(tree, ModelConfig(**ARMS[arm]))
    rules = pmesh.param_shardings(None, AMCModel(ModelConfig(**ARMS[arm])))
    assert sorted(rules) == sorted(sd)
    split = 0
    for name, t in sd.items():
        varies = [d for d in range(t.dim()) if (t - t.narrow(d, 0, 1)).abs().sum() > 0]
        assert varies == ([] if rules[name] is None else [rules[name]]), name
        split += rules[name] is not None
    assert split == 10 * ARMS[arm]["n_layers"]  # 4 x 2 column + 2 row-weight entries a layer


def test_shard_model_slices_heads_in_vitiqs_column_order():
    cfg = ModelConfig(**ARMS["rawiq"])
    whole = AMCModel(cfg, generator=torch.Generator().manual_seed(1))
    sd = {k: v.clone() for k, v in whole.state_dict().items()}
    mesh = pmesh.make_mesh(data=1, model=2, devices=[0, 1])
    mesh.rank = 1
    pmesh.shard_model(whole, mesh)
    got = whole.state_dict()
    layer = "encoder.layers.0"
    # head h of 4 (d_head 8) owns rows 8h:8h+8: rank 1 holds heads 2 and 3
    assert torch.equal(got[f"{layer}.attention.w_q.weight"],
                       sd[f"{layer}.attention.w_q.weight"][16:])
    assert torch.equal(got[f"{layer}.attention.w_v.bias"], sd[f"{layer}.attention.w_v.bias"][16:])
    assert torch.equal(got[f"{layer}.attention.w_concat.weight"],
                       sd[f"{layer}.attention.w_concat.weight"][:, 16:])
    assert torch.equal(got[f"{layer}.attention.w_concat.bias"],
                       sd[f"{layer}.attention.w_concat.bias"])
    assert torch.equal(got[f"{layer}.ffn.linear2.weight"],
                       sd[f"{layer}.ffn.linear2.weight"][:, 32:])
    assert pmesh.shard_state_dict(sd, whole).keys() == got.keys()
    assert all(torch.equal(pmesh.shard_state_dict(sd, whole)[k], got[k]) for k in got)
    assert whole.mesh is mesh and whole.encoder.mesh is mesh
    with pytest.raises(ValueError, match="already sharded"):
        pmesh.shard_model(whole, pmesh.make_mesh(data=1, model=2, devices=[0, 1]))
    bad = AMCModel(ModelConfig(**{**ARMS["rawiq"], "ffn_hidden": 66}))
    with pytest.raises(ValueError, match="divisible"):
        pmesh.shard_model(bad, pmesh.make_mesh(data=1, model=4, devices=RANKS[:4]))


@pytest.mark.parametrize("seed", [0, 7, -5, 2 ** 31 - 1, -2 ** 31, 123456789])
@pytest.mark.parametrize("idx", [0, 1, 3, 7])
def test_data_fold_is_vitiqs_int32_arithmetic(seed, idx):
    want = int(jnp.int32(seed) + jnp.int32(idx) * jnp.int32(-1640531527))
    assert fold_data_index(seed, idx) == want
    t = fold_data_index(torch.tensor(seed, dtype=torch.int32), idx)
    assert t.dtype == torch.int32 and int(t) == want


def test_a_column_shard_drops_the_whole_activations_lanes():
    """The FFN hidden site's mask of a shard numbered from its first lane is
    the whole activation's mask over those lanes, forward and backward."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 9, 64), generator=gen)
    salt = flt.site_salt(2, 1)
    whole = flt.hash_dropout_plain(x, 0.3, -77, salt)
    for j in range(4):
        part = x[..., 16 * j:16 * (j + 1)].clone().requires_grad_(True)
        got = flt.hash_dropout(part, 0.3, -77, salt, lane0=16 * j)
        assert torch.equal(got, whole[..., 16 * j:16 * (j + 1)])
        (g,) = torch.autograd.grad(got.sum(), part)
        assert torch.equal(g == 0, got == 0)


def test_training_without_a_seed_raises_as_in_vitiq():
    """Dropout on, training, no seed: vitiq's forward raises (its dropout
    wants an rng), and so does the port's, instead of drawing one."""
    kw = dict(ARMS["rawiq"], drop_prob=0.1)
    x = np.random.default_rng(0).standard_normal((2, 2, 64)).astype(np.float32)
    vcfg = VModelConfig(**kw)
    with pytest.raises(ValueError, match="requires an rng"):
        make_forward(vcfg)(init_amc_params(jax.random.PRNGKey(0), vcfg), jnp.asarray(x),
                           train=True)
    model = AMCModel(ModelConfig(**kw)).train()
    with pytest.raises(ValueError, match="requires the step's seed"):
        model(torch.from_numpy(x))
    assert model(torch.from_numpy(x), seed=3).shape == (2, 5)
