"""The port's device mesh in spawned gloo worlds on the CPU, against vitiq's
meshes on the 8-device virtual CPU mesh and against one-process runs.

Three worlds (`parallel.comm.spawn`, a ``file://`` store under the test's
temporary directory), each rank a process that imports no JAX; the JAX
references are built in the pytest process and reach the ranks as files:

* DP 2: `fit` over ``make_mesh(data=2)`` (6 one-step epochs, `reference`
  numerics, dropout 0) against vitiq's `fit` over its ``make_mesh(data=2)``
  and the port's one-process `fit`: per-step losses within rtol 1e-4,
  final parameters within atol 1e-4; at dropout 0.2 the two data ranks draw
  different masks, and a rerun draws the same bits; a sharded `predict_feed`
  equals the one-process predictions.
* DP 2 x TP 2: the tensor-parallel forward against vitiq's under its
  ``make_mesh(data=2, model=2)`` (atol 2e-5, vitiq's own bound), then `fit`
  and a checkpoint that loads into a one-process port model and, through
  `vitiq.interop`, into vitiq with the same logits, and that a one-process
  `fit` resumes.
* TP 2: three train steps at dropout 0.1 against one process (the hash
  masks are the seed's, the FFN hidden site's lanes numbered from the
  shard's first column): the first step's whole gradient at atol 1e-6,
  losses at rtol 1e-5, parameters at atol 1e-4 (AdamW turns the key bias's
  gradient, zero up to rounding, into steps of the learning rate); then
  ``cli train --model_parallel 2`` writes, from rank 0, the one-process
  layout, which vitiq's `load_params` reads.
"""

import json
import sys

import numpy as np
import pytest
import torch

from vitiq_torch import cli
from vitiq_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from vitiq_torch.dsp.frontend import preprocess_batch_rawiq
from vitiq_torch.eval.evaluate import predict_feed
from vitiq_torch.models import AMCModel
from vitiq_torch.models.encoder import fold_data_index
from vitiq_torch.parallel import comm
from vitiq_torch.parallel.mesh import full_state_dict, make_mesh, shard_batch, shard_model
from vitiq_torch.train import loop as ploop
from vitiq_torch.train import optim as poptim
from vitiq_torch.train.checkpoint import save_checkpoint

STATS = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
MODEL = dict(arm="rawiq", num_classes=2, d_model=32, n_head=4, n_layers=2, ffn_hidden=64,
             drop_prob=0.0, seq_length=128, segment_size=16, numerics="reference")
TRAIN = dict(batch_size=32, num_epochs=6, learning_rate=1e-3, weight_decay=1e-4, patience=50)


def _data():
    """One train batch (so each epoch is one step), 32 validation rows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 128, 2)).astype(np.float32)
    y = (np.arange(64) % 2).astype(np.int32)
    return (x[:32], y[:32]), (x[32:], y[32:])


def _pre(x):
    return preprocess_batch_rawiq(x, STATS)


def _cfg(**train):
    return ExperimentConfig(model=ModelConfig(**MODEL), train=TrainConfig(**{**TRAIN, **train}))


def _model(weights, **model):
    m = AMCModel(ModelConfig(**{**MODEL, **model}))
    m.load_state_dict(weights)
    return m


def _start():
    torch.set_num_threads(1)
    assert "jax" not in sys.modules and "vitiq" not in sys.modules


def _numpy(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


# --------------------------------------------------------------------------
# the ranks (module-level, so the spawned processes import them by name)
# --------------------------------------------------------------------------

def dp_worker(rank, world, tmp):
    _start()
    weights = torch.load(f"{tmp}/weights.pt")
    cfg = _cfg(data_parallel=2)
    model = _model(weights)
    res = ploop.fit(cfg, model, *_data(), preprocess_fn=_pre, verbose=False)
    assert model.mesh.shape == {"data": 2, "model": 1}
    out = {"history": res.history, "params": _numpy(model.state_dict())}
    # dropout: each data rank folds its index into the seed
    dropped = _model(weights, drop_prob=0.2).train()
    shard_model(dropped, make_mesh(data=2))
    x = _pre(torch.from_numpy(_data()[0][0][:8]))
    with torch.no_grad():
        out["masks"] = [torch.equal(dropped(x, seed=11), dropped(x, seed=11)),
                        dropped(x, seed=11).numpy()]
    # a sharded predict_feed over 37 rows in batches of 8
    from vitiq_torch.data.feeds import ArrayFeed

    xs = np.random.default_rng(3).standard_normal((37, 128, 2)).astype(np.float32)
    model.eval()
    out["preds"] = predict_feed(model, ArrayFeed(xs, np.zeros(37, np.int32)), 8, "cpu",
                                _pre)[0]
    torch.save(out, f"{tmp}/dp{rank}.pt")


def dp_tp_worker(rank, world, tmp):
    _start()
    ref = torch.load(f"{tmp}/tp_ref.pt")
    model = _model(ref["weights"])
    mesh = make_mesh(data=2, model=2)
    shard_model(model, mesh)
    model.eval()
    with torch.no_grad():
        x = ref["x"]
        tp_logits = model(shard_batch(x, mesh)).numpy()
    cfg = _cfg(data_parallel=2, model_parallel=2, num_epochs=2)
    res = ploop.fit(cfg, model, *_data(), preprocess_fn=_pre, verbose=False)
    save_checkpoint(f"{tmp}/ck", res.state, 1, res.history["val_loss"][-1], res.history, cfg)
    model.eval()
    with torch.no_grad():
        logits = model(x).numpy()
    torch.save({"tp_logits": tp_logits, "data_index": mesh.data_index(),
                "model_index": mesh.model_index(), "logits": logits},
               f"{tmp}/dptp{rank}.pt")


def _tp_steps(model, steps=3):
    """The first step's gradient (whole) and `steps` steps' losses at
    dropout seed 5."""
    from vitiq_torch.ops.metrics import label_smoothed_cross_entropy

    cfg = _cfg()
    state = poptim.create_train_state(model, cfg.train)
    step = ploop.make_train_step(poptim.make_optimizer(cfg.train, model), 0.0, _pre)
    (x, y), _ = _data()
    model.train()
    names, params = zip(*model.named_parameters())
    loss = label_smoothed_cross_entropy(
        model(_pre(torch.from_numpy(x)), seed=ploop.step_seed_tensor(5, state.step)),
        torch.from_numpy(y).long(), 0.0)
    grads = full_state_dict(model, dict(zip(names, torch.autograd.grad(loss, params))))
    losses = []
    for _ in range(steps):
        state, m = step(state, x, y, 5)
        losses.append(float(m["loss"]))
    return _numpy(grads), losses


def tp_worker(rank, world, tmp):
    _start()
    weights = torch.load(f"{tmp}/weights.pt")
    model = _model(weights, drop_prob=0.1)
    shard_model(model, make_mesh(data=1, model=2))
    grads, losses = _tp_steps(model)
    params = _numpy(full_state_dict(model))
    # the runner and the CLI over the same mesh: rank 0 writes
    cli.main(["train", "--config", f"{tmp}/exp.json", "--device", "cpu", "--no_plots",
              "--model_parallel", "2"])
    torch.save({"grads": grads, "losses": losses, "params": params}, f"{tmp}/tp{rank}.pt")


# --------------------------------------------------------------------------
# the checks, in the pytest process
# --------------------------------------------------------------------------

def _vitiq_weights(tmp_path):
    import jax

    from vitiq.config import ModelConfig as VModelConfig
    from vitiq.models import init_amc_params
    from vitiq_torch.interop import state_dict_from_vitiq

    params = init_amc_params(jax.random.PRNGKey(0), VModelConfig(**MODEL))
    weights = state_dict_from_vitiq(params, ModelConfig(**MODEL))
    torch.save(weights, tmp_path / "weights.pt")
    return params, weights


def test_dp2_fit_equals_vitiqs_dp2_fit_and_one_process(tmp_path):
    import jax

    from vitiq.config import ExperimentConfig as VExperimentConfig
    from vitiq.config import ModelConfig as VModelConfig
    from vitiq.config import TrainConfig as VTrainConfig
    from vitiq.dsp import preprocess_batch_rawiq as jax_preprocess_rawiq
    from vitiq.models import make_forward
    from vitiq.parallel import make_mesh as vitiq_make_mesh
    from vitiq.train.loop import fit as vitiq_fit
    from vitiq_torch.data.feeds import ArrayFeed
    from vitiq_torch.interop import state_dict_from_vitiq

    params, weights = _vitiq_weights(tmp_path)
    comm.spawn(dp_worker, 2, str(tmp_path), device="cpu")
    ranks = [torch.load(tmp_path / f"dp{r}.pt", weights_only=False) for r in range(2)]

    vcfg = VExperimentConfig(model=VModelConfig(**MODEL),
                             train=VTrainConfig(**TRAIN, data_parallel=2))
    jres = vitiq_fit(vcfg, make_forward(vcfg.model), params, *_data(),
                     preprocess_fn=lambda x: jax_preprocess_rawiq(x, STATS), verbose=False,
                     mesh=vitiq_make_mesh(data=2))
    one = _model(weights)
    pres = ploop.fit(_cfg(), one, *_data(), preprocess_fn=_pre, verbose=False)
    vparams = state_dict_from_vitiq(jax.device_get(jres.state.params), ModelConfig(**MODEL))
    assert ranks[0]["history"]["train_loss"] == ranks[1]["history"]["train_loss"]
    for want, label in ((jres.history, "vitiq DP 2"), (pres.history, "port DP 1")):
        for key in ("train_loss", "val_loss", "train_acc", "val_acc"):
            np.testing.assert_allclose(ranks[0]["history"][key], want[key], rtol=1e-4,
                                       err_msg=f"{label} {key}")
    for name, got in ranks[0]["params"].items():
        np.testing.assert_allclose(got, vparams[name].numpy(), atol=1e-4, err_msg=name)
        np.testing.assert_allclose(got, one.state_dict()[name].numpy(), atol=1e-4,
                                   err_msg=name)

    # the two data ranks draw different masks, each the same bits on a rerun:
    # data rank i's are one process's at the seed 11 + i * -1640531527
    assert ranks[0]["masks"][0] and ranks[1]["masks"][0]
    dropped = _model(weights, drop_prob=0.2).train()
    x = _pre(torch.from_numpy(_data()[0][0][:8]))
    with torch.no_grad():
        for i, r in enumerate(ranks):
            want = dropped(x, seed=fold_data_index(11, i)).numpy()
            np.testing.assert_array_equal(r["masks"][1], want)
    assert not np.allclose(ranks[0]["masks"][1], ranks[1]["masks"][1])

    xs = np.random.default_rng(3).standard_normal((37, 128, 2)).astype(np.float32)
    one.eval()
    single = predict_feed(one, ArrayFeed(xs, np.zeros(37, np.int32)), 8, "cpu", _pre)[0]
    np.testing.assert_array_equal(single, np.asarray(ranks[0]["preds"]))
    np.testing.assert_array_equal(single, np.asarray(ranks[1]["preds"]))
    sharded = one
    sharded.mesh = make_mesh(data=2, devices=[0, 1])
    with pytest.raises(ValueError, match="divide evenly"):
        predict_feed(sharded, ArrayFeed(xs, np.zeros(37, np.int32)), 7, "cpu", _pre)


def test_dp2_tp2_forward_and_checkpoint_match_vitiq(tmp_path):
    import jax
    import jax.numpy as jnp

    from vitiq.config import ModelConfig as VModelConfig
    from vitiq.interop import load_torch_state_dict
    from vitiq.models import make_forward
    from vitiq.parallel import make_mesh as vitiq_make_mesh
    from vitiq.parallel import shard_batch as vitiq_shard_batch
    from vitiq.parallel import shard_params as vitiq_shard_params
    from vitiq_torch.train.checkpoint import load_checkpoint

    params, weights = _vitiq_weights(tmp_path)
    x = np.random.default_rng(0).standard_normal((8, 2, 128)).astype(np.float32)
    torch.save({"weights": weights, "x": torch.from_numpy(x)}, tmp_path / "tp_ref.pt")
    comm.spawn(dp_tp_worker, 4, str(tmp_path), device="cpu")
    ranks = [torch.load(tmp_path / f"dptp{r}.pt", weights_only=False) for r in range(4)]

    vcfg = VModelConfig(**MODEL)
    fwd = make_forward(vcfg)
    mesh = vitiq_make_mesh(data=2, model=2)
    with mesh:
        want = np.asarray(jax.jit(fwd)(vitiq_shard_params(params, mesh),
                                       vitiq_shard_batch(jnp.asarray(x), mesh)))
    for r in ranks:
        i = r["data_index"]
        np.testing.assert_allclose(r["tp_logits"], want[4 * i:4 * (i + 1)], atol=2e-5)
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])

    # the checkpoint of the DP 2 x TP 2 run in a one-process port model ...
    cfg = _cfg(num_epochs=3)
    model = AMCModel(cfg.model)
    state, manifest = load_checkpoint(tmp_path / "ck", poptim.create_train_state(model,
                                                                                cfg.train))
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, ranks[0]["logits"], atol=1e-5)
    # ... and in vitiq
    vparams = load_torch_state_dict(model.state_dict(), vcfg)
    np.testing.assert_allclose(np.asarray(fwd(vparams, jnp.asarray(x))), logits, atol=1e-4)
    # a one-process fit resumes it
    res = ploop.fit(cfg, model, *_data(), preprocess_fn=_pre, verbose=False, resume_state=state,
                    resume_history=manifest["history"], start_epoch=manifest["epoch"] + 1)
    assert len(res.history["train_loss"]) == 3 and int(state.step) == 3


def test_tp2_steps_with_dropout_equal_one_process_and_cli_train(tmp_path):
    import jax

    from vitiq.config import ModelConfig as VModelConfig
    from vitiq.models import init_amc_params
    from vitiq.train.checkpoint import load_params as vitiq_load_params
    from vitiq_torch.interop import state_dict_from_vitiq
    from vitiq_torch.train.checkpoint import load_params

    _, weights = _vitiq_weights(tmp_path)
    exp = _cfg(num_epochs=1, batch_size=16, save_freq=1)
    exp.data = DataConfig(synthetic_frames_per_class=40, synthetic_frame_len=128)
    exp.model = ModelConfig(**{**MODEL, "drop_prob": 0.1})
    exp.checkpoint_dir, exp.log_dir = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    exp.to_json(str(tmp_path / "exp.json"))
    comm.spawn(tp_worker, 2, str(tmp_path), device="cpu")
    ranks = [torch.load(tmp_path / f"tp{r}.pt", weights_only=False) for r in range(2)]

    one = _model(weights, drop_prob=0.1)
    grads, losses = _tp_steps(one)
    for r in ranks:
        for name, got in r["grads"].items():
            np.testing.assert_allclose(got, grads[name], atol=1e-6, err_msg=name)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        # AdamW turns the key bias's gradient, zero up to rounding, into
        # steps of the learning rate's size: the parameters at the DP bound
        for name, got in r["params"].items():
            np.testing.assert_allclose(got, one.state_dict()[name].numpy(), atol=1e-4,
                                       err_msg=name)
    exp_dir = tmp_path / "ckpt" / exp.experiment_name
    summary = json.loads((exp_dir / "summary.json").read_text())
    assert summary["epochs_run"] == 1 and "test_overall_accuracy" in summary
    mcfg = ExperimentConfig.from_json(str(exp_dir / "config.json")).model
    vcfg = VModelConfig(**{**MODEL, "drop_prob": 0.1, "num_classes": mcfg.num_classes})
    vparams = vitiq_load_params(exp_dir / "model_best.npz",
                                init_amc_params(jax.random.PRNGKey(1), vcfg))
    assert vparams["encoder"]["layers"][0]["attention"]["w_q"]["kernel"].shape == (32, 32)
    got = load_params(exp_dir / "model_best.npz", mcfg)
    for name, t in state_dict_from_vitiq(vparams, mcfg).items():
        np.testing.assert_array_equal(t.numpy(), got[name].numpy())
