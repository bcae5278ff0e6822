"""vitiq_torch — the PyTorch / CUDA port of vitiq for NVIDIA Hopper GPUs.

`vitiq/` (JAX, Pallas kernels for the TPU) is the reference implementation;
this package computes the same functions with PyTorch and hand-written CUDA
kernels, and its tests hold it against `vitiq` on shared weights and inputs.
The layout mirrors `vitiq/`: the counterpart of `vitiq/models/encoder.py` is
`vitiq_torch/models/encoder.py`, and so on. Module `state_dict` keys are the
reference PyTorch checkpoint's own (`vitiq/interop.py`), so reference `.pth`
files load with a plain `load_state_dict`.

The port imports nothing of `vitiq` (and so no JAX): what it needs of a
`vitiq` module it keeps as its own copy (`vitiq_torch/config.py` copies
`vitiq/config.py`). Only the tests import both packages.

Devices: the entry points a user calls run on the card unless the caller
asks for another device -- `serve.build_forward_and_preprocess(...,
device="cuda")`, `serve.Server(..., device="cuda")`, and
`serve.build_serving_fn(..., device)` with its device required; they raise
where CUDA is absent and never fall back to the CPU (pass ``device="cpu"``
for a run on the host). The modules (`AMCModel`, `Encoder`, `EncoderLayer`)
keep PyTorch's ``device=None`` constructor idiom instead: a module is built
where its caller says, on the CPU by default, like any `torch.nn.Module`.

Ported so far: numerics policies, attention, the encoder layers,
embeddings, encoder, classifier heads, the ViT / rawIQ front-ends,
checkpoint interop, the bucketed server and the CUDA port of the fused
encoder-layer kernels (`csrc/fused_encoder_layer.cu`) for serving; the loss
and metrics, clip + AdamW, the plateau and early-stopping controllers, the
in-RAM feed, the train and eval steps and `fit`, and the CUDA port of the
fused training layer, forward and backward (`csrc/fused_layer_train.cu`),
for training; the standalone packed attention, forward and flash backward
(`csrc/flash_attention.cu`, K5), which every plain layer runs under `tpu`
numerics (the conv1d arm's 1025 tokens in training, with each layer
rematerialized above 512 tokens); the evaluation of a saved experiment
(`runner.run_evaluation`, `python -m vitiq_torch.cli evaluate`: the synthetic
corpus and its stats, `vitiq`'s parameter files, the confusion artifacts and
the byte-compatible report), in float and through int8 W8A8 serving
(`ops/quant.py`) with the CUDA port of the int8 fused layer (K6, in
`csrc/fused_encoder_layer.cu`); the training runner (`runner.run_training`,
`python -m vitiq_torch.cli train`: config.json, rolling and periodic
checkpoints, the interrupt rescue, ``resume="auto"``, the test evaluation
and summary.json) with full TrainState checkpoints in `vitiq`'s leaf layout
(`train/checkpoint.py`, AdamW's moments included), which either package
resumes; the CUDA port of the int8-attention layer (K7, in
`csrc/fused_encoder_layer.cu`), which every float evaluation pass runs under
``VITIQ_ATTN_INT8=1``; and the thesis's head-to-head (`runner.run_head_to_head`,
`python -m vitiq_torch.cli head-to-head` and `compare`: both arms trained and
evaluated, then the cross-arm comparison of `eval/compare.py`); and the data
path from file to card: the HDF5 source and the reference split (numpy, no
scikit-learn), packed shards, the streaming feed, the prefetching
host-to-device feed (`data/`), per-step profiling (`utils/profiling.py`) and
the evaluation of a reference `.pth` (`runner.run_reference_evaluation`,
`python -m vitiq_torch.cli evaluate --torch-checkpoint`); and the DSP
front-end (`dsp/`): the RRC matched filter, symbol timing recovery (the
Gardner and Mueller-Mueller loops one launch of `csrc/timing.cu`, a kernel
with no TPU twin), the SPS, spectrogram, amplitude/phase and MDF front-ends,
the polyphase channelizer and the streaming classifier (`streaming.py`),
taken by `serve.build_preprocess` and so by serving, training and
evaluation; the serving artifact (`serve.export_serving`,
`serve.ServingArtifact`, `serve.export_from_experiment`, `python -m
vitiq_torch.cli export`: the weights, config and stats, loaded on the card as
one captured CUDA graph a batch bucket), MDF-NET (`models/mdf.py`) and the
softmax calibration guard (`ops/guards.py`, `interop.load_torch_checkpoint`);
device-scan training (`train/loop.make_train_scan_step`, which `fit` takes
for every full group of `TrainConfig.device_scan_steps` batches: on the card
the group's train steps are one replay of a captured CUDA graph, their step
counter, dropout seed, learning rate and AdamW state on the device, K3/K4
reading the seed from device memory), the PSO hyperparameter sweep
(`sweep.py`, `python -m vitiq_torch.cli sweep`: each architecture's short
training one captured graph on the card) and the preprocessing figures
(`viz.py`, `python -m vitiq_torch.cli visualize`, a host tool); and the
device mesh (`parallel/`: data and tensor parallelism over
`torch.distributed`, one process a rank, started by torchrun or
`parallel.comm.spawn`), `ProcessShardFeed`, and `cli train --data_parallel /
--model_parallel`; and the throughput module (`bench.py`, `python -m
vitiq_torch.cli bench` with vitiq's `--which` choices, and `python -m
vitiq_torch.bench`, the counterpart of the JAX package's headline benchmark) over
vitiq's nine bench geometries, `rawiq_seg64_config`, `rawiq_seg64_mp_config`
and `rawiq_mp_config` among them: on the card each timed step is one
captured CUDA graph, timed by the slope over its replays beside the eager
step.

Every module of `vitiq/` has its counterpart here but two.

Not ported, by design: `vitiq/utils/compile_cache.py` keeps XLA's persistent
compilation cache, and the port compiles nothing at run time but its kernel
library, which `ops/cuda/_build.py` already keeps under `build/` keyed by the
sources' hash; `vitiq/train/orbax_io.py` wraps Orbax checkpointing, a JAX
library, and the port's checkpoints are vitiq's npz-plus-manifest layout
(`train/checkpoint.py`), which either package reads and resumes.
"""

from vitiq_torch.config import (  # noqa: F401
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
    flagship_conv1d_config,
    flagship_rawiq_config,
    flagship_vit_config,
)

__version__ = "0.1.0"
