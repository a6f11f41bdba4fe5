"""The reference in a lower precision than a cell states: the control that
the comparison must fail.

Every convolution's operands (its input and its weight) are rounded to the
lower format before a float32 convolution, as a tensor core rounds them:

  * ``tf32``: float32 with TF32 off -> TF32, 10 mantissa bits kept (round
    to nearest even);
  * ``bf16``: the bf16 policy's own rounding of a convolution's operands and
    output, a witness beside the program, not a control;
  * ``fp8``: bfloat16 -> float8 where the bf16 policy keeps bfloat16: a
    convolution's operands and its output in e4m3 (each tensor scaled by
    its largest magnitude over 448 first), and the gradient of its output
    in e5m2 (scaled to 57344) before the backward's convolutions.

The operands' rounding passes gradients through unchanged, so a control can
train.
"""

import torch
from torch import nn
from torch.nn.utils import parametrize

CONVS = (nn.Conv2d, nn.ConvTranspose2d)


def round_tf32(x):
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _scaled(x, dtype, top):
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def round_fp8(x):
    return _scaled(x, torch.float8_e4m3fn, 448.0)


def round_bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


ROUND = {'tf32': round_tf32, 'fp8': round_fp8, 'bf16': round_bf16}


class _Output(torch.autograd.Function):
    """An fp8 convolution's output: e4m3 forward, e5m2 gradient."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, grad):
        return _scaled(grad, torch.float8_e5m2, 57344.0)


class _Straight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        return ROUND[fmt](x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Rounded(nn.Module):
    def __init__(self, fmt):
        super().__init__()
        self.fmt = fmt

    def forward(self, w):
        return _Straight.apply(w, self.fmt)


def lower_precision(model, fmt):
    """Round ``model``'s convolution operands to ``fmt`` from now on (in
    place); returns the model."""
    for m in model.modules():
        if isinstance(m, CONVS):
            parametrize.register_parametrization(m, 'weight', _Rounded(fmt))
            m.register_forward_pre_hook(lambda _, args: (_Straight.apply(args[0], fmt),))
            if fmt == 'fp8':
                m.register_forward_hook(lambda _, args, out: _Output.apply(out))
            elif fmt == 'bf16':
                m.register_forward_hook(lambda _, args, out: _Straight.apply(out, fmt))
    return model
