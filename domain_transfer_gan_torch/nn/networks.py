"""The six networks of the model family, as ``nn.Module``s.

- :class:`CINResnetGenerator`   G_A->B, latent-conditioned: z is injected at
  every norm site through a conditional instance norm.
- :class:`ResnetGenerator`      G_B->A, deterministic.
- :class:`Discriminator`        D_B, PatchGAN (13x13 patch logits at 64x64).
- :class:`DiscriminatorEdges`   D_A, one global logit at 64x64.
- :class:`DiscriminatorLatent`  D_z_B, an MLP on z.
- :class:`LatentEncoder`        E_B, conv stack -> (mu, logvar).

Module and parameter names follow the JAX package's parameter tree
(``conv0``, ``cin0/shift_conv``, ``block0/norm2``, ``nr0/norm``, ``nl1/norm``,
``bn0/bn``, ``up0``...), so ``utils.convert`` maps one onto the other by path.
``n_blocks`` is honoured and defaults to 3.  (The JAX package also carries
``CINDiscriminator``, which nothing instantiates; it is not ported.)

Public layout: images NHWC ``(N, H, W, C)``, z flat ``(N, nlatent)`` (a 4-D
``(N, nlatent, 1, 1)`` is flattened).  Inside, activations are NCHW tensors in
``channels_last`` memory format in the compute dtype; image outputs are NHWC
in the compute dtype.  Parameters are float32 unless ``place`` cast them for
serving; every layer casts them to its input's dtype per use (``nn.layers``).
Train or eval mode is the module's own (``net.train()`` / ``net.eval()``): it
steers dropout and the batch norms.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import hints, pipeline
from ..parallel.spatial import conv_transpose2d_layer, image_rows
from .blocks import CINResnetBlock, ResnetBlock
from .init import init_kernel_, torch_linear_init_
from .layers import Conv2d, Dropout, Linear, sliced_layer
from .norms import (
    BatchNorm1d,
    BatchNorm2d,
    CondInstanceNorm,
    InstanceNorm,
    make_norm,
    running_stats_held,
)


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
        return sliced_layer(self, x, lambda x_, w, b: conv_transpose2d_layer(
            x_, w, b, self.stride, self.padding, self.output_padding), 1)


class _NormRelu(nn.Module):
    """norm -> ReLU; with an instance norm the ReLU is fused into the
    kernel."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        self.norm = make_norm(kind, features)
        self.fused = isinstance(self.norm, InstanceNorm)
        if self.fused:
            self.norm.fuse_relu = True

    def forward(self, x, plain_norm: bool = False):
        h = self.norm(x, plain_norm)
        return h if self.fused else F.relu(h)


class _NormLRelu(nn.Module):
    """norm -> LeakyReLU(0.2).  The instance norm runs without a fused
    activation; the LeakyReLU is a separate elementwise pass."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        self.norm = make_norm(kind, features)

    def forward(self, x, plain_norm: bool = False):
        return F.leaky_relu(self.norm(x, plain_norm), 0.2)


class _Net(nn.Module):
    """What the networks share: init, placement, layout at the edges, and
    ``--remat`` for the generators."""

    compute_dtype = torch.float32
    # --remat: the generators' forward runs under torch.utils.checkpoint
    # while grad is enabled (models.state sets it)
    remat = False
    dropout_generator: Optional[torch.Generator] = None

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
            elif isinstance(m, (InstanceNorm, CondInstanceNorm, BatchNorm2d)):
                m.reset_parameters(scheme, generator)
        return self

    def place(self, device, dtype: torch.dtype = torch.float32,
              cast_weights: bool = True):
        """Move to ``device`` and compute in ``dtype`` (kernels in
        channels_last).  With ``cast_weights`` (serving) the conv and Linear
        weights are stored in ``dtype``; without (training) every parameter
        stays float32 and is cast per use.  Norm parameters and running
        statistics are fp32 either way."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("compute dtype must be float32 or bfloat16, "
                             "got %s" % dtype)
        self.to(device=device, memory_format=torch.channels_last)
        if cast_weights:
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear, TorchConvTranspose)):
                    m.to(dtype)
        self.compute_dtype = dtype
        return self

    def set_dropout_generator(self, generator: Optional[torch.Generator]):
        """Draw every dropout mask of this net from ``generator``."""
        self.dropout_generator = generator
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator
        return self

    def _maybe_remat(self, fn, *args):
        """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
        when ``remat`` is set and grad is enabled: the activations are not
        kept, the backward runs ``fn`` again.  That recompute must be the
        same function: it replays the dropout masks of the first run (the
        state of ``dropout_generator``, which the checkpoint's own RNG
        handling does not cover, is saved before it and restored around the
        recompute, then put back where the stream had got to), and its batch
        norms do not advance their running statistics a second time."""
        if not (self.remat and torch.is_grad_enabled()):
            return fn(*args)
        gen = self.dropout_generator
        start = gen.get_state() if gen is not None else None
        runs = []

        def run(*a):
            if not runs:
                runs.append(1)
                return fn(*a)
            now = gen.get_state() if gen is not None else None
            if gen is not None:
                gen.set_state(start)
            try:
                with running_stats_held(self):
                    return fn(*a)
            finally:
                if gen is not None:
                    gen.set_state(now)

        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=gen is None)

    def _trunk(self, h, z, plain_norm):
        """The residual blocks in turn (``z``: the CIN code, None for blocks
        without one); inside a train step over a pipe axis
        (``parallel.pipeline.active_engine``) a GPipe schedule over it,
        where the trunk can take one (no dropout, instance norms: the
        ``trunk_fn`` the JAX ``apply_net`` injects)."""
        blocks = [getattr(self, "block%d" % i) for i in range(self.n_blocks)]
        engine = pipeline.active_engine()
        if engine is not None and self.pipelineable():
            return pipeline.gpipe_trunk(engine, blocks, h, z, plain_norm)
        for blk in blocks:
            h = blk(h, plain_norm) if z is None else blk(h, z, plain_norm)
        return h

    def pipelineable(self) -> bool:
        """Whether the trunk runs as a pipeline (per-sample norms, no
        dropout)."""
        return all(not isinstance(m, (Dropout, BatchNorm2d))
                   for i in range(self.n_blocks)
                   for m in getattr(self, "block%d" % i).modules())

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4:
            raise ValueError("images must be NHWC (N, H, W, C), got %r"
                             % (tuple(x.shape),))
        return x.to(self.compute_dtype).permute(0, 3, 1, 2)

    @staticmethod
    def _leave(h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(h).permute(0, 2, 3, 1).contiguous()


class CINResnetGenerator(_Net):
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
        self.conv0 = Conv2d(input_nc, ngf, 7)
        self.cin0 = cin(ngf)
        self.conv1 = Conv2d(ngf, 2 * ngf, 3, padding=1)
        self.cin1 = cin(2 * ngf)
        self.conv2 = Conv2d(2 * ngf, 4 * ngf, 3, stride=2, padding=1)
        self.cin2 = cin(4 * ngf)
        for i in range(n_blocks):
            self.add_module("block%d" % i, CINResnetBlock(
                4 * ngf, nlatent, padding_type=padding_type,
                use_dropout=use_dropout))
        self.up0 = TorchConvTranspose(4 * ngf, 2 * ngf, 3, 2, 1, 1)
        self.cin3 = cin(2 * ngf)
        self.conv3 = Conv2d(2 * ngf, ngf, 3, padding=1)
        self.cin4 = cin(ngf)
        self.conv4 = Conv2d(ngf, output_nc, 7, padding=3)

    def forward(self, x: torch.Tensor, z: torch.Tensor,
                plain_norm: bool = False) -> torch.Tensor:
        """x: NHWC image batch, z: (N, nlatent).  ``plain_norm`` is for
        tests: it sends every norm through the kernel's plain version."""
        if z.dim() == 4:  # accept the upstream layout (N, nlatent, 1, 1)
            z = z.reshape(z.shape[0], -1)
        if z.shape != (x.shape[0], self.nlatent):
            raise ValueError("z must be (%d, %d), got %r"
                             % (x.shape[0], self.nlatent, tuple(z.shape)))
        return self._maybe_remat(self._body, x, z.to(self.compute_dtype),
                                 plain_norm)

    def _body(self, x, z, plain_norm):
        with image_rows():
            h = self.conv0(self._enter(x), pre_pad=3, pad_mode="reflect")
            h = self.cin0(h, z, plain_norm)
            h = self.cin1(self.conv1(h), z, plain_norm)
            h = self.cin2(self.conv2(h), z, plain_norm)
            h = self._trunk(h, z, plain_norm)
            h = self.cin3(self.up0(h), z, plain_norm)
            h = self.cin4(self.conv3(h), z, plain_norm)
            return self._leave(self.conv4(h))


class ResnetGenerator(_Net):
    """Deterministic ResNet generator G_B->A."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 32,
                 n_blocks: int = 3, norm: str = "instance",
                 use_dropout: bool = False, padding_type: str = "reflect"):
        super().__init__()
        self.n_blocks = n_blocks
        self.conv0 = Conv2d(input_nc, ngf, 7)
        self.nr0 = _NormRelu(norm, ngf)
        self.conv1 = Conv2d(ngf, 2 * ngf, 3, padding=1)
        self.nr1 = _NormRelu(norm, 2 * ngf)
        self.conv2 = Conv2d(2 * ngf, 4 * ngf, 3, stride=2, padding=1)
        self.nr2 = _NormRelu(norm, 4 * ngf)
        for i in range(n_blocks):
            self.add_module("block%d" % i, ResnetBlock(
                4 * ngf, padding_type=padding_type, norm=norm,
                use_dropout=use_dropout))
        self.up0 = TorchConvTranspose(4 * ngf, 2 * ngf, 3, 2, 1, 1)
        self.nr3 = _NormRelu(norm, 2 * ngf)
        self.conv3 = Conv2d(2 * ngf, ngf, 3, padding=1)
        self.nr4 = _NormRelu(norm, ngf)
        self.conv4 = Conv2d(ngf, output_nc, 7, padding=3)

    def forward(self, x: torch.Tensor,
                plain_norm: bool = False) -> torch.Tensor:
        return self._maybe_remat(self._body, x, plain_norm)

    def _body(self, x, plain_norm):
        with image_rows():
            h = self.conv0(self._enter(x), pre_pad=3, pad_mode="reflect")
            h = self.nr0(h, plain_norm)
            h = self.nr1(self.conv1(h), plain_norm)
            h = self.nr2(self.conv2(h), plain_norm)
            h = self._trunk(h, None, plain_norm)
            h = self.nr3(self.up0(h), plain_norm)
            h = self.nr4(self.conv3(h), plain_norm)
            return self._leave(self.conv4(h))


def _flat_logits(h: torch.Tensor, use_sigmoid: bool) -> torch.Tensor:
    """An NCHW prediction map as NHWC, through a Sigmoid in the vanilla-GAN
    mode."""
    h = h.permute(0, 2, 3, 1)
    return torch.sigmoid(h) if use_sigmoid else h


class Discriminator(_Net):
    """PatchGAN discriminator D_B.  On a 64x64 input it answers a 13x13 grid
    of patch logits, NHWC ``(N, 13, 13, 1)``."""

    def __init__(self, input_nc: int, ndf: int = 64, norm: str = "instance",
                 use_sigmoid: bool = False):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.conv0 = Conv2d(input_nc, ndf, 4, stride=2, padding=1)
        self.conv1 = Conv2d(ndf, 2 * ndf, 4, stride=2, padding=1)
        self.nl1 = _NormLRelu(norm, 2 * ndf)
        self.conv2 = Conv2d(2 * ndf, 4 * ndf, 4, padding=1)
        self.nl2 = _NormLRelu(norm, 4 * ndf)
        self.conv3 = Conv2d(4 * ndf, 4 * ndf, 4, padding=1)
        self.nl3 = _NormLRelu(norm, 4 * ndf)
        self.conv4 = Conv2d(4 * ndf, 1, 4, padding=1)

    def forward(self, x: torch.Tensor, plain_norm: bool = False):
        with image_rows():
            h = F.leaky_relu(self.conv0(self._enter(x)), 0.2)
            h = self.nl1(self.conv1(h), plain_norm)
            # under a space axis conv2's rows (H/4 - 1) never split evenly:
            # its input is gathered (parallel.spatial.conv2d_layer) and the
            # patch map computed whole on every space rank
            h = self.nl2(self.conv2(h), plain_norm)
            h = self.nl3(self.conv3(h), plain_norm)
            return _flat_logits(self.conv4(h), self.use_sigmoid)


class DiscriminatorEdges(_Net):
    """Global discriminator D_A: four stride-2 3x3 convs, then a valid 4x4
    conv, one logit ``(N, 1, 1, 1)`` on a 64x64 input."""

    def __init__(self, input_nc: int, ndf: int = 32, norm: str = "instance",
                 use_sigmoid: bool = False):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.conv0 = Conv2d(input_nc, ndf, 3, stride=2, padding=1)
        self.conv1 = Conv2d(ndf, 2 * ndf, 3, stride=2, padding=1)
        self.nl1 = _NormLRelu(norm, 2 * ndf)
        self.conv2 = Conv2d(2 * ndf, 4 * ndf, 3, stride=2, padding=1)
        self.nl2 = _NormLRelu(norm, 4 * ndf)
        self.conv3 = Conv2d(4 * ndf, 4 * ndf, 3, stride=2, padding=1)
        self.nl3 = _NormLRelu(norm, 4 * ndf)
        self.conv4 = Conv2d(4 * ndf, 1, 4)

    def forward(self, x: torch.Tensor, plain_norm: bool = False):
        with image_rows():
            h = F.leaky_relu(self.conv0(self._enter(x)), 0.2)
            h = self.nl1(self.conv1(h), plain_norm)
            h = self.nl2(self.conv2(h), plain_norm)
            h = self.nl3(self.conv3(h), plain_norm)
            # the 4x4 head collapses the image: all of H (JAX pins it to
            # batch-only sharding here)
            h = hints.pin_batch_only(h)
            return _flat_logits(self.conv4(h), self.use_sigmoid)


class DiscriminatorLatent(_Net):
    """MLP latent discriminator D_z_B:
    3x [Linear(ndf) + BatchNorm1d + LeakyReLU(0.2)] + Linear(1), ``(N, 1)``.

    Under the ``reference`` init its Linear layers keep the PyTorch default
    (weight and bias ~ U(+-1/sqrt(fan_in))); under ``sane`` LeCun-normal
    weights and zero biases.
    """

    def __init__(self, nlatent: int, ndf: int = 64, use_sigmoid: bool = False):
        super().__init__()
        self.nlatent = nlatent
        self.use_sigmoid = use_sigmoid
        self.fc0 = Linear(nlatent, ndf)
        self.bn0 = BatchNorm1d(ndf)
        self.fc1 = Linear(ndf, ndf)
        self.bn1 = BatchNorm1d(ndf)
        self.fc2 = Linear(ndf, ndf)
        self.bn2 = BatchNorm1d(ndf)
        self.fc3 = Linear(ndf, 1)

    def reset_parameters(self, scheme: str, generator: torch.Generator):
        for lin in (self.fc0, self.fc1, self.fc2, self.fc3):
            if scheme == "reference":
                torch_linear_init_(lin.weight.data, lin.in_features, generator)
                torch_linear_init_(lin.bias.data, lin.in_features, generator)
            else:
                init_kernel_(lin.weight.data, lin.in_features, scheme,
                             generator)
                lin.bias.data.zero_()
        return self

    def forward(self, z: torch.Tensor, plain_norm: bool = False):
        if z.dim() == 4:
            z = z.reshape(z.shape[0], self.nlatent)
        with image_rows(sliced=False):  # z: whole on every space rank
            h = z.to(self.compute_dtype)
            h = F.leaky_relu(self.bn0(self.fc0(h)), 0.2)
            h = F.leaky_relu(self.bn1(self.fc1(h)), 0.2)
            h = F.leaky_relu(self.bn2(self.fc2(h)), 0.2)
            h = self.fc3(h)
            return torch.sigmoid(h) if self.use_sigmoid else h


class LatentEncoder(_Net):
    """Conv latent encoder E_B: four stride-2 3x3 convs, a valid 4x4 conv,
    then 1x1 conv heads for (mu, logvar), each ``(N, nlatent)``.

    ``conv1..conv4`` have no bias.  The flatten assumes the conv stack
    reduced H, W to 1x1, i.e. 64x64 inputs; ``adaptive_pool`` averages a
    larger feature map first.
    """

    def __init__(self, nlatent: int, input_nc: int, nef: int = 32,
                 norm: str = "batch", adaptive_pool: bool = False):
        super().__init__()
        self.adaptive_pool = adaptive_pool
        self.conv0 = Conv2d(input_nc, nef, 3, stride=2, padding=1)
        self.conv1 = Conv2d(nef, 2 * nef, 3, stride=2, padding=1, bias=False)
        self.nr1 = _NormRelu(norm, 2 * nef)
        self.conv2 = Conv2d(2 * nef, 4 * nef, 3, stride=2, padding=1,
                            bias=False)
        self.nr2 = _NormRelu(norm, 4 * nef)
        self.conv3 = Conv2d(4 * nef, 8 * nef, 3, stride=2, padding=1,
                            bias=False)
        self.nr3 = _NormRelu(norm, 8 * nef)
        self.conv4 = Conv2d(8 * nef, 8 * nef, 4, bias=False)
        self.nr4 = _NormRelu(norm, 8 * nef)
        self.enc_mu = Conv2d(8 * nef, nlatent, 1)
        self.enc_logvar = Conv2d(8 * nef, nlatent, 1)

    def forward(self, x: torch.Tensor, plain_norm: bool = False):
        with image_rows():
            return self._heads(self._stack(x, plain_norm))

    def _stack(self, x, plain_norm):
        h = F.relu(self.conv0(self._enter(x)))
        h = self.nr1(self.conv1(h), plain_norm)
        h = self.nr2(self.conv2(h), plain_norm)
        h = self.nr3(self.conv3(h), plain_norm)
        # the valid 4x4 conv collapses the image: all of H (JAX pins it to
        # batch-only sharding here)
        h = hints.pin_batch_only(h)
        return self.nr4(self.conv4(h), plain_norm)

    def _heads(self, h):
        if self.adaptive_pool and (h.shape[2] > 1 or h.shape[3] > 1):
            h = h.mean(dim=(2, 3), keepdim=True)
        mu = self.enc_mu(h).permute(0, 2, 3, 1)
        logvar = self.enc_logvar(h).permute(0, 2, 3, 1)
        return (mu.reshape(mu.shape[0], -1),
                logvar.reshape(logvar.shape[0], -1))


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


def define_D_A(input_nc, ndf, norm="instance", use_sigmoid=False,
               init_scheme="reference",
               generator: Optional[torch.Generator] = None):
    net = DiscriminatorEdges(input_nc=input_nc, ndf=ndf, norm=norm,
                             use_sigmoid=use_sigmoid)
    return net.reset_parameters(init_scheme, generator or torch.Generator())


def define_D_B(input_nc, ndf, norm="instance", use_sigmoid=False,
               init_scheme="reference",
               generator: Optional[torch.Generator] = None):
    net = Discriminator(input_nc=input_nc, ndf=ndf, norm=norm,
                        use_sigmoid=use_sigmoid)
    return net.reset_parameters(init_scheme, generator or torch.Generator())


def define_LAT_D(nlatent, ndf, use_sigmoid=False, init_scheme="reference",
                 generator: Optional[torch.Generator] = None):
    net = DiscriminatorLatent(nlatent=nlatent, ndf=ndf,
                              use_sigmoid=use_sigmoid)
    return net.reset_parameters(init_scheme, generator or torch.Generator())


def define_E(nlatent, input_nc, nef, norm="batch", init_scheme="reference",
             adaptive_pool=False,
             generator: Optional[torch.Generator] = None):
    net = LatentEncoder(nlatent=nlatent, input_nc=input_nc, nef=nef,
                        norm=norm, adaptive_pool=adaptive_pool)
    return net.reset_parameters(init_scheme, generator or torch.Generator())


@contextlib.contextmanager
def frozen(net: nn.Module, training: bool):
    """``net`` in train or eval mode as ``training`` says, its parameters
    not requiring grad, and its buffers (batch-norm running statistics)
    restored on exit: a forward in train mode uses batch statistics but
    leaves no trace."""
    mode = net.training
    requires = [p.requires_grad for p in net.parameters()]
    buffers = [b.clone() for b in net.buffers()]
    net.train(training)
    net.requires_grad_(False)
    try:
        yield net
    finally:
        with torch.no_grad():
            for b, saved in zip(net.buffers(), buffers):
                b.copy_(saved)
        for p, r in zip(net.parameters(), requires):
            p.requires_grad_(r)
        net.train(mode)


def count_params(net: nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())


def print_network(name: str, net: nn.Module, out_f=None) -> int:
    """Parameter count + name -> ``nets.txt``."""
    n = count_params(net)
    if out_f is not None:
        out_f.write("%s\n" % name)
        out_f.write("Total number of parameters: %d\n" % n)
        out_f.flush()
    return n
