"""Diagnostic probes on Hopper: the counterparts of the JAX package's TPU
lowering and cost probes under scripts/ (`tpu_probe_mask_ops.py`,
`tpu_probe_refcost.py`, `tpu_probe_exp.py`), one module each.

* `mask_ops` (P1): each masking idiom of K1's narrow attention tile as a
  kernel of its own (`csrc/probes.cu`), built, launched and held to its
  plain version.
* `refcost` (P2): what an operand costs a block, three kernels moving the
  same bytes through 32, 8 or 2 operands.
* `exp` (P3): K1 with its softmax exp removed, timed against K1.

Each runs on the card as ``python -m vitiq_torch.probes.<name>`` with the
TPU script's positional arguments and printed lines; `_timing` times them
with CUDA events. Their wrappers run the plain versions on CPU tensors,
which the CPU tests hold against the TPU probes in interpret mode.
"""
