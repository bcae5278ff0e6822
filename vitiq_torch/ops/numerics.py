"""Numerics policies (counterpart of `vitiq/ops/numerics.py`).

* ``REFERENCE`` — float32 everywhere, with TF32 off in both cuBLAS and cuDNN:
  the counterpart of JAX's ``Precision.HIGHEST`` (true f32 products).
* ``TPU`` — bfloat16 matmul operands with float32 accumulation, float32
  softmax and LayerNorm statistics, activations written back in bf16
  (``cast_output``). The name is the reference's preset name
  (`ModelConfig.validate` accepts only ``reference|tpu``).

A bf16 @ bf16 matmul in PyTorch returns bf16 on the CPU, where JAX's
``preferred_element_type=f32`` returns the f32 accumulator. ``Policy.dot``
therefore rounds the operands to the compute dtype and multiplies them in
f32: the product of two bf16 values is exact in f32, so this is the
f32-accumulated result on every device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    """Casting rules for one forward pass. Parameters, matmul accumulation,
    softmax and LayerNorm statistics are always f32."""

    compute_dtype: torch.dtype  # dtype the matmul operands are rounded to

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_output(self, x: torch.Tensor) -> torch.Tensor:
        """Activations written between ops travel in the compute dtype."""
        if self.compute_dtype == torch.float32:
            return x
        return x.to(self.compute_dtype)

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        return self.cast_compute(x).float()

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a[..., K] @ b[K, N]`` on compute-dtype operands, f32 result."""
        return torch.matmul(self._operand(a), self._operand(b))

    def einsum(self, spec: str, *args: torch.Tensor) -> torch.Tensor:
        return torch.einsum(spec, *(self._operand(a) for a in args))


REFERENCE = Policy(compute_dtype=torch.float32)
TPU = Policy(compute_dtype=torch.bfloat16)


def policy_for(numerics: str) -> Policy:
    if numerics == "reference":
        # full-f32 products on the GPU: cuDNN convolutions default to TF32,
        # and cuBLAS matmuls do wherever a program turned it on
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return REFERENCE
    if numerics == "tpu":
        return TPU
    raise ValueError(f"unknown numerics preset {numerics!r}")
