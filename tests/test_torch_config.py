"""The port's own `vitiq_torch.config` against `vitiq.config`, which it
copies (the port imports nothing of `vitiq`): the same dataclass fields and
defaults, dicts that round-trip from either package into the other, equal
presets, and flagship geometries equal to `vitiq.bench`'s."""

import dataclasses

import pytest

import vitiq.bench as jbench
import vitiq.config as jcfg
import vitiq_torch.config as pcfg

CLASSES = ("ModelConfig", "DataConfig", "TrainConfig", "ExperimentConfig")
PRESETS = ("vit_reference", "vit_tpu_production", "vit_synthetic19", "rawiq_synthetic19",
           "vit_tiny_2016", "rawiq_reference", "rawiq_best")


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        value = f.default_factory()
        return dataclasses.asdict(value) if dataclasses.is_dataclass(value) else value
    return dataclasses.MISSING


@pytest.mark.parametrize("name", CLASSES)
def test_same_fields_and_defaults(name):
    want, got = getattr(jcfg, name), getattr(pcfg, name)
    assert got is not want
    assert ([(f.name, f.type, _default(f)) for f in dataclasses.fields(got)]
            == [(f.name, f.type, _default(f)) for f in dataclasses.fields(want)])
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())


def test_module_constants_equal():
    for name in ("TARGET_MODULATIONS_19", "TARGET_MODULATIONS_24", "RADIOML_2016_CLASSES"):
        assert getattr(pcfg, name) == getattr(jcfg, name)


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_equal_and_round_trip_across_packages(preset):
    want = getattr(jcfg.ExperimentConfig, preset)()
    got = getattr(pcfg.ExperimentConfig, preset)()
    assert got.to_dict() == want.to_dict()
    assert pcfg.ExperimentConfig.from_dict(want.to_dict()).to_dict() == want.to_dict()
    assert jcfg.ExperimentConfig.from_dict(got.to_dict()).to_dict() == got.to_dict()
    assert pcfg.ExperimentConfig.from_json(want.to_json()).to_dict() == want.to_dict()
    assert (got.model.num_tokens, got.model.d_head) == (want.model.num_tokens,
                                                        want.model.d_head)


def test_overrides_and_reference_import_match():
    over = {"model.n_head": 4, "learning_rate": 3e-4, "sps": 2, "experiment_name": "x"}
    assert (pcfg.ExperimentConfig.rawiq_reference(**over).to_dict()
            == jcfg.ExperimentConfig.rawiq_reference(**over).to_dict())
    with pytest.raises(AttributeError, match="unknown config key"):
        pcfg.ExperimentConfig.vit_reference(bogus=1)
    ref = {"D_MODEL": 64, "N_HEAD": 4, "SEGMENT_SIZE": 32, "EMBEDDING_TYPE": "segment",
           "TARGET_MODULATIONS": ["BPSK", "QPSK"], "BATCH_SIZE": 64}
    assert (pcfg.ExperimentConfig.from_reference_dict(ref).to_dict()
            == jcfg.ExperimentConfig.from_reference_dict(ref).to_dict())


@pytest.mark.parametrize("kwargs", [dict(d_model=30, n_head=8), dict(arm="cnn"),
                                    dict(arm="rawiq", seq_length=100),
                                    dict(numerics="fp8"), dict(drop_prob=1.0)])
def test_validation_errors_match(kwargs):
    with pytest.raises(ValueError) as want:
        jcfg.ModelConfig(**kwargs).validate()
    with pytest.raises(ValueError) as got:
        pcfg.ModelConfig(**kwargs).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["flagship_vit_config", "flagship_rawiq_config",
                                  "flagship_conv1d_config", "rawiq_best_config",
                                  "rawiq_best_mp_config", "vit_tiny_2016_config"])
@pytest.mark.parametrize("numerics", ["tpu", "reference"])
def test_flagships_equal_vitiq_bench(name, numerics):
    got, want = getattr(pcfg, name)(numerics), getattr(jbench, name)(numerics)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_tokens == want.num_tokens


def test_conv1d_flagship_geometry():
    cfg = pcfg.flagship_conv1d_config()
    assert (cfg.num_tokens, cfg.d_model, cfg.n_head, cfg.n_layers, cfg.ffn_hidden,
            cfg.embedding_type, cfg.drop_prob) == (1025, 128, 8, 6, 1024, "conv1d", 0.2)
