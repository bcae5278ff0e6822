"""MDF-NET: the multi-domain-fusion CNN-LSTM (counterpart of
`vitiq/models/mdf.py`, the reconstruction of the reference notebook's
missing `CNN_LSTM_new`, ref: ViT/MDF_NET.ipynb).

Two separately parameterized CNN towers over the amplitude and phase images
[B, 1, 32, 32] (three 3x3 'SAME' Conv2d + ReLU + 2x2 max-pool layers of 32 /
64 / 128 channels, then the global mean), a 1x8 stride-8 'VALID' conv front
end (2 -> 64 channels, ReLU) that takes the I/Q sequence [B, 1024, 2] to 128
steps, an LSTM of hidden size 128 over them (its final hidden state), and a
fused head over the concatenated 384 features: dropout, ``fuse1`` (384 ->
256) + ReLU, dropout, ``head``. Dropout is drawn only in training with a
generator (vitiq's ``train and rng is not None``).

No Pallas kernel computes any of it: the convolutions and the LSTM are
PyTorch's (`nn.Conv2d`, `nn.LSTM`, gate order i, f, g, o as vitiq's). They
run in float32 with cuDNN's TF32 off (`dsp.filtering.f32_conv`), as the JAX
package computes them in float32, in the forward and in the backward:
autograd would run their backward under the global flag, after the forward's
scope has closed, so where gradients are taken the towers, the front end and
the LSTM run as one `_F32Region`, whose backward differentiates their graph
inside the scope. Parameters are initialized as
vitiq initializes them (U(-1/sqrt(fan_in), +) for every kernel and bias; the
LSTM's input and recurrent kernels by their own fan-ins), drawn from
`generator`; `interop.mdf_state_dict_from_vitiq` carries vitiq's parameters
over. Its inputs are `dsp.frontend.preprocess_batch_mdf`'s.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vitiq_torch.dsp.filtering import f32_conv
from vitiq_torch.models.layers import Linear, _uniform_

CNN_CHANNELS = (32, 64, 128)
IQ_CONV_CH = 64
IQ_CONV_STRIDE = 8
LSTM_HIDDEN = 128
FUSION_HIDDEN = 256


def _conv(c_in: int, c_out: int, kernel, stride=1, padding=0, device=None,
          generator: Optional[torch.Generator] = None) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=padding, device=device)
    bound = 1.0 / math.sqrt(c_in * conv.kernel_size[0] * conv.kernel_size[1])
    _uniform_(conv.weight, bound, generator)
    _uniform_(conv.bias, bound, generator)
    return conv


class _F32Region(torch.autograd.Function):
    """region(*inputs), built and differentiated inside `f32_conv()`: the
    forward builds the region's graph on detached inputs (the parameters,
    passed after them, are its leaves as they are), the backward takes its
    gradients with `torch.autograd.grad` in the scope."""

    @staticmethod
    def forward(ctx, region, n_inputs: int, *tensors):
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in tensors[:n_inputs]]
        with torch.enable_grad(), f32_conv():
            out = region(*inputs)
        ctx.graph = (out, inputs + list(tensors[n_inputs:]))
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        out, leaves = ctx.graph
        wrt = [t for t in leaves if t.requires_grad]
        with f32_conv():
            grads = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
        return (None, None, *(next(grads) if t.requires_grad else None for t in leaves))


class MultiDomainModel(nn.Module):
    """(amp [B, 1, 32, 32], phase [B, 1, 32, 32], iq_seq [B, L, 2]) ->
    logits [B, num_classes] f32."""

    def __init__(self, num_classes: int, dropout_rate: float = 0.7, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate

        def tower():
            chans = (1,) + CNN_CHANNELS
            return nn.ModuleList(_conv(a, b, 3, padding=1, device=device, generator=generator)
                                 for a, b in zip(chans, chans[1:]))

        self.amp_cnn = tower()
        self.phase_cnn = tower()
        self.iq_conv = _conv(2, IQ_CONV_CH, (1, IQ_CONV_STRIDE), stride=(1, IQ_CONV_STRIDE),
                             device=device, generator=generator)
        self.lstm = nn.LSTM(IQ_CONV_CH, LSTM_HIDDEN, batch_first=True, device=device)
        for name, fan_in in (("ih", IQ_CONV_CH), ("hh", LSTM_HIDDEN)):
            bound = 1.0 / math.sqrt(fan_in)
            _uniform_(getattr(self.lstm, f"weight_{name}_l0"), bound, generator)
            _uniform_(getattr(self.lstm, f"bias_{name}_l0"), bound, generator)
        self.fuse1 = Linear(2 * CNN_CHANNELS[-1] + LSTM_HIDDEN, FUSION_HIDDEN, device, generator)
        self.head = Linear(FUSION_HIDDEN, num_classes, device, generator)

    @staticmethod
    def _tower(convs: nn.ModuleList, img: torch.Tensor) -> torch.Tensor:
        x = img
        for conv in convs:
            x = F.max_pool2d(F.relu(conv(x)), 2)
        return x.mean(dim=(2, 3))

    def _features(self, amp: torch.Tensor, phase: torch.Tensor,
                  iq_seq: torch.Tensor) -> torch.Tensor:
        """The towers' and the LSTM's features, [B, 384]."""
        f_amp = self._tower(self.amp_cnn, amp)
        f_ph = self._tower(self.phase_cnn, phase)
        # [B, L, 2] -> [B, 2, 1, L] -> strided conv -> [B, T, C]
        x = F.relu(self.iq_conv(iq_seq.transpose(1, 2)[:, :, None, :]))
        _, (h, _) = self.lstm(x[:, :, 0, :].transpose(1, 2))
        return torch.cat([f_amp, f_ph, h[-1]], dim=-1)

    def forward(self, amp: torch.Tensor, phase: torch.Tensor, iq_seq: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        params = [p for m in (self.amp_cnn, self.phase_cnn, self.iq_conv, self.lstm)
                  for p in m.parameters()]
        inputs = (amp, phase, iq_seq)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (*inputs, *params)):
            fused = _F32Region.apply(self._features, len(inputs), *inputs, *params)
        else:
            with f32_conv():
                fused = self._features(*inputs)
        drop_on = train and generator is not None
        fused = dropout(fused, self.dropout_rate, drop_on, generator)
        hid = F.relu(self.fuse1(fused))
        hid = dropout(hid, self.dropout_rate, drop_on, generator)
        return self.head(hid).float()


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """MDF-NET's inverted dropout (vitiq's, with a generator for its rng);
    identity when not training. The keep mask is drawn from `generator` (on
    `x`'s device). The AMC encoder's dropout is `layers.dropout` instead:
    the fused kernels' hash of the step's seed."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand(x.shape, device=x.device, generator=generator)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def create_multi_domain_model(num_classes: int, dropout_rate: float = 0.7, device=None,
                              generator: Optional[torch.Generator] = None) -> MultiDomainModel:
    """Factory mirroring the notebook's `CNN_LSTM_new` API (MDF_NET.ipynb
    cell 16), as vitiq's `create_multi_domain_model`: here one module."""
    return MultiDomainModel(num_classes, dropout_rate, device, generator)
