"""The two generators of the serving path, as ``nn.Module``s.

- :class:`CINResnetGenerator`  G_A->B, latent-conditioned: z is injected at
  every norm site through a conditional instance norm.
- :class:`ResnetGenerator`     G_B->A, deterministic.

Module and parameter names follow the JAX package's parameter tree
(``conv0``, ``cin0/shift_conv``, ``block0/norm2``, ``nr0/norm``, ``up0``...),
so ``utils.convert`` maps one onto the other by path.  ``n_blocks`` is
honoured and defaults to 3.

Public layout: images NHWC ``(N, H, W, C)``, z flat ``(N, nlatent)`` (a 4-D
``(N, nlatent, 1, 1)`` is flattened).  Inside, activations are NCHW tensors in
``channels_last`` memory format in the compute dtype; the output is NHWC in
the compute dtype.  The discriminators and the latent encoder are ported with
the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.convs import conv_transpose2d_torch, reflect_pad2d
from .blocks import CINResnetBlock, ResnetBlock, _check_norm
from .init import init_kernel_
from .norms import CondInstanceNorm, InstanceNorm


class TorchConvTranspose(nn.Module):
    """ConvTranspose2d(k, s, p, op); weight (Cin, Cout, k, k)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(
            torch.zeros(in_features, features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        return conv_transpose2d_torch(x, self.weight, self.bias, self.stride,
                                      self.padding, self.output_padding)


class _NormRelu(nn.Module):
    """norm -> ReLU with the ReLU fused into the instance-norm kernel."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        _check_norm(kind)
        self.norm = InstanceNorm(features, affine=True, fuse_relu=True)

    def forward(self, x, plain_norm: bool = False):
        return self.norm(x, plain_norm)


class _Generator(nn.Module):
    """What the two generators share: init, placement, layout at the edges."""

    compute_dtype = torch.float32

    def reset_parameters(self, scheme: str, generator: torch.Generator):
        """Draw every parameter anew under ``scheme`` from ``generator``,
        in module registration order."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, TorchConvTranspose)):
                # fan-in of the JAX (kh, kw, Cin, Cout) kernel: kh * kw * Cin
                cin = m.weight.shape[0 if isinstance(m, TorchConvTranspose)
                                     else 1]
                fan_in = cin * m.weight.shape[2] * m.weight.shape[3]
                init_kernel_(m.weight.data, fan_in, scheme, generator)
                if m.bias is not None:
                    m.bias.data.zero_()
            elif isinstance(m, (InstanceNorm, CondInstanceNorm)):
                m.reset_parameters(scheme, generator)
        return self

    def place(self, device, dtype: torch.dtype = torch.float32):
        """Move to ``device`` with conv and Linear weights in ``dtype``
        (kernels in channels_last); the InstanceNorm scale/shift stay fp32."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("compute dtype must be float32 or bfloat16, "
                             "got %s" % dtype)
        self.to(device=device, memory_format=torch.channels_last)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, TorchConvTranspose)):
                m.to(dtype)
        self.compute_dtype = dtype
        return self

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError("images must be NHWC (N, H, W, C), got %r"
                             % (tuple(x.shape),))
        return x.to(self.compute_dtype).permute(0, 3, 1, 2)

    @staticmethod
    def _leave(h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(h).permute(0, 2, 3, 1).contiguous()


class CINResnetGenerator(_Generator):
    """Latent-conditioned ResNet generator G_A->B.

    The stem downsamples once (stride 2) to H/2, ``n_blocks`` CIN residual
    blocks run at 4*ngf, then it upsamples back.  Every norm of the stem and
    the head is a CIN that injects z; final activation Tanh.
    """

    def __init__(self, nlatent: int, input_nc: int, output_nc: int,
                 ngf: int = 32, n_blocks: int = 3, use_dropout: bool = False,
                 padding_type: str = "reflect"):
        super().__init__()
        self.nlatent = nlatent
        self.n_blocks = n_blocks
        cin = lambda f: CondInstanceNorm(f, nlatent, fuse_relu=True)
        self.conv0 = nn.Conv2d(input_nc, ngf, 7)
        self.cin0 = cin(ngf)
        self.conv1 = nn.Conv2d(ngf, 2 * ngf, 3, padding=1)
        self.cin1 = cin(2 * ngf)
        self.conv2 = nn.Conv2d(2 * ngf, 4 * ngf, 3, stride=2, padding=1)
        self.cin2 = cin(4 * ngf)
        for i in range(n_blocks):
            self.add_module("block%d" % i, CINResnetBlock(
                4 * ngf, nlatent, padding_type=padding_type,
                use_dropout=use_dropout))
        self.up0 = TorchConvTranspose(4 * ngf, 2 * ngf, 3, 2, 1, 1)
        self.cin3 = cin(2 * ngf)
        self.conv3 = nn.Conv2d(2 * ngf, ngf, 3, padding=1)
        self.cin4 = cin(ngf)
        self.conv4 = nn.Conv2d(ngf, output_nc, 7, padding=3)

    def forward(self, x: torch.Tensor, z: torch.Tensor,
                plain_norm: bool = False) -> torch.Tensor:
        """x: NHWC image batch, z: (N, nlatent).  ``plain_norm`` is for
        tests: it sends every norm through the kernel's plain version."""
        if z.dim() == 4:  # accept the upstream layout (N, nlatent, 1, 1)
            z = z.reshape(z.shape[0], -1)
        if z.shape != (x.shape[0], self.nlatent):
            raise ValueError("z must be (%d, %d), got %r"
                             % (x.shape[0], self.nlatent, tuple(z.shape)))
        z = z.to(self.compute_dtype)
        h = self.conv0(reflect_pad2d(self._enter(x), 3))
        h = self.cin0(h, z, plain_norm)
        h = self.cin1(self.conv1(h), z, plain_norm)
        h = self.cin2(self.conv2(h), z, plain_norm)
        for i in range(self.n_blocks):
            h = getattr(self, "block%d" % i)(h, z, plain_norm)
        h = self.cin3(self.up0(h), z, plain_norm)
        h = self.cin4(self.conv3(h), z, plain_norm)
        return self._leave(self.conv4(h))


class ResnetGenerator(_Generator):
    """Deterministic ResNet generator G_B->A."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 32,
                 n_blocks: int = 3, norm: str = "instance",
                 use_dropout: bool = False, padding_type: str = "reflect"):
        super().__init__()
        _check_norm(norm)
        self.n_blocks = n_blocks
        self.conv0 = nn.Conv2d(input_nc, ngf, 7)
        self.nr0 = _NormRelu(norm, ngf)
        self.conv1 = nn.Conv2d(ngf, 2 * ngf, 3, padding=1)
        self.nr1 = _NormRelu(norm, 2 * ngf)
        self.conv2 = nn.Conv2d(2 * ngf, 4 * ngf, 3, stride=2, padding=1)
        self.nr2 = _NormRelu(norm, 4 * ngf)
        for i in range(n_blocks):
            self.add_module("block%d" % i, ResnetBlock(
                4 * ngf, padding_type=padding_type, norm=norm,
                use_dropout=use_dropout))
        self.up0 = TorchConvTranspose(4 * ngf, 2 * ngf, 3, 2, 1, 1)
        self.nr3 = _NormRelu(norm, 2 * ngf)
        self.conv3 = nn.Conv2d(2 * ngf, ngf, 3, padding=1)
        self.nr4 = _NormRelu(norm, ngf)
        self.conv4 = nn.Conv2d(ngf, output_nc, 7, padding=3)

    def forward(self, x: torch.Tensor,
                plain_norm: bool = False) -> torch.Tensor:
        h = self.conv0(reflect_pad2d(self._enter(x), 3))
        h = self.nr0(h, plain_norm)
        h = self.nr1(self.conv1(h), plain_norm)
        h = self.nr2(self.conv2(h), plain_norm)
        for i in range(self.n_blocks):
            h = getattr(self, "block%d" % i)(h, plain_norm)
        h = self.nr3(self.up0(h), plain_norm)
        h = self.nr4(self.conv3(h), plain_norm)
        return self._leave(self.conv4(h))


# ---------------------------------------------------------------------------
# Factories under the JAX package's names.  ``generator`` seeds the draw; the
# parameters are made on the CPU, so a seed gives the same weights on every
# device.  Call ``.place(device, dtype)`` on the result.
# ---------------------------------------------------------------------------

def define_G(input_nc, output_nc, ngf, norm="instance", use_dropout=False,
             n_blocks=3, init_scheme="reference",
             generator: Optional[torch.Generator] = None):
    net = ResnetGenerator(input_nc=input_nc, output_nc=output_nc, ngf=ngf,
                          n_blocks=n_blocks, norm=norm,
                          use_dropout=use_dropout)
    return net.reset_parameters(init_scheme, generator or torch.Generator())


def define_stochastic_G(nlatent, input_nc, output_nc, ngf, norm="instance",
                        use_dropout=False, n_blocks=3,
                        init_scheme="reference",
                        generator: Optional[torch.Generator] = None):
    net = CINResnetGenerator(nlatent=nlatent, input_nc=input_nc,
                             output_nc=output_nc, ngf=ngf, n_blocks=n_blocks,
                             use_dropout=use_dropout)
    return net.reset_parameters(init_scheme, generator or torch.Generator())


def count_params(net: nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())
