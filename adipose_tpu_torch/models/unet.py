"""Dilated-bottleneck U-Net (``adipose_tpu/models/unet.py``) in PyTorch.

Architecture (the JAX module's docstring has the reference lines):

  encoder    3 levels of [Conv3x3-ReLU x2 -> MaxPool2] at init_nb*(1,2,4)
  bottleneck six Conv3x3-ReLU at init_nb*8, dilation 1..32, fed in sequence
             with dropout after the first, all six summed
  decoder    3 levels of [nearest-x2 upsample -> Conv3x3 -> skip concat ->
             Conv3x3 x2 -> dropout]; without autograd the upsample and its
             conv run as one stride-2 transposed 4x4 conv
             (:class:`FusedUpsampleConv`)
  head       Conv1x1 -> 2-way softmax -> class 1, computed as
             sigmoid(l1 - l0) by the CUDA head kernel (``fast_head``)
  aux heads  (optional) Conv1x1-sigmoid at up3 and up2, bilinearly resized;
             through the head kernel too with ``fast_head``

With ``fast_head`` the heads are differentiable through the head kernel's
backward (:func:`~adipose_tpu_torch.ops.cuda.unet_kernels.diff_sigmoid_head`).
Dropout is Flax's: in training it draws its keep-mask with ``torch.rand``
from the ``generator`` passed to :meth:`DilatedUNet.forward` and scales the
kept values by 1 / (1 - rate); it never reads the global RNG.

Layout and casts follow the JAX module: params stay float32 and are cast to
the compute dtype at use; activations are NCHW tensors in
``torch.channels_last`` memory, so the convs run channels-last in cuDNN and
the head kernel reads each pixel's channels contiguously. The input is cast
to the compute dtype before the first conv, biases are added in the compute
dtype, the bottleneck taps are summed in order in the compute dtype, and the
heads accumulate in float32. Every activation is stored at :func:`lane`
channels, the next multiple of 8, as the JAX module pads its level-1
channels (``lane_pad``): the extra channels are exact zeros, the weights and
biases are zero-padded at use and the params keep their shapes, so the
function is the unpadded one. At ``init_nb`` 44 that is level 1, at 48.

Layer names are the Keras names the JAX module keeps, so
:mod:`adipose_tpu_torch.models.convert` maps Flax params one to one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from adipose_tpu_torch.core import tracing
from adipose_tpu_torch.ops.cuda.unet_kernels import diff_sigmoid_head
from adipose_tpu_torch.parallel.collectives import gather_rows
from adipose_tpu_torch.parallel.spatial import halo_exchange, spatial_max_pool2

_CL = torch.channels_last
# Flax's lecun_normal: truncated normal on [-2, 2] std, rescaled so the
# truncated distribution's std is sqrt(1 / fan_in).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init, in place: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in (fan_in = the
    elements of ``w[0]``, for an OIHW conv or an (out, in) Dense weight)."""
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def lane(channels: int) -> int:
    """The channels a U-Net activation of ``channels`` channels is stored at:
    the next multiple of 8, so that each bf16 pixel's channels fill whole
    16-byte groups, as cuDNN's tensor-core convs read them (it copies any
    other count into a padded buffer and back on every call)."""
    return -(-channels // 8) * 8


def zero_padded(t: torch.Tensor, size: tuple, dtype: torch.dtype,
                blocks: int = 1) -> torch.Tensor:
    """``t`` cast to ``dtype`` in the leading corner of a zero tensor of
    ``size``, channels-last if 4-d; ``blocks`` splits dim 1 of both into
    that many equal blocks, each padded at its end (the blocks of a concat).
    One launch where ``size`` is ``t``'s (the cast), else two (fill, copy);
    differentiable in ``t``."""
    fmt = _CL if t.dim() == 4 else torch.contiguous_format
    if tuple(size) == tuple(t.shape):
        return t.to(dtype, memory_format=fmt)
    out = torch.empty(size, dtype=dtype, device=t.device, memory_format=fmt).zero_()
    dst, src = out, t
    if blocks > 1:
        dst, src = out.unflatten(1, (blocks, -1)), t.unflatten(1, (blocks, -1))
    dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
    return out


class Conv(nn.Module):
    """A Keras-named conv layer: float32 OIHW weight and bias, applied in the
    input's dtype with "SAME" padding.

    ``width_in`` and ``width_out`` are the channels its input (each of the
    input's ``blocks`` equal blocks, for a conv over a concat) and its output
    are stored at, where more than the params': the weight and bias are then
    zero-padded at use (:func:`zero_padded`), so the extra output channels
    are exact zeros and the extra input channels meet zero taps."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, dilation: int = 1,
                 device=None, *, blocks: int = 1, width_in: int | None = None,
                 width_out: int | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))
        self.dilation = dilation
        self.padding = dilation * (kernel_size // 2)
        self.blocks = blocks
        self.width_in = width_in or cin // blocks
        self.width_out = width_out or cout
        self.padded = self.width_in * blocks != cin or self.width_out != cout

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun_normal weight and zero bias, as Flax initializes ``nn.Conv``."""
        with torch.no_grad():
            lecun_normal_(self.weight, generator)
            self.bias.zero_()

    def count_pad(self) -> None:
        """Count a call that runs on padded channels (``conv.channel_pad``)."""
        if self.padded:
            tracing.count("conv.channel_pad", 1)

    def forward(self, x: torch.Tensor, valid_h: bool = False) -> torch.Tensor:
        """SAME, or with ``valid_h`` SAME on W and VALID on H: the rows of
        a slab padded with its neighbours' rows (a halo)."""
        self.count_pad()
        k = self.weight.shape[-1]
        w = zero_padded(self.weight, (self.width_out, self.blocks * self.width_in, k, k),
                        x.dtype, self.blocks)
        b = zero_padded(self.bias, (self.width_out,), x.dtype)
        padding = (0, self.padding) if valid_h else self.padding
        return F.conv2d(x, w, b, padding=padding, dilation=self.dilation)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Keras ``UpSampling2D`` default (nearest x2)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """``tf.image.resize(..., 'bilinear')``: half-pixel centers, no corner
    alignment."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


def fold_upsample_kernel(weight: torch.Tensor, dtype: torch.dtype,
                         widths: tuple | None = None) -> torch.Tensor:
    """The (cin, cout, 4, 4) weight ``w`` for which ``F.conv_transpose2d(x, w,
    stride=2, padding=1)`` equals a nearest-x2 upsample (Keras'
    ``UpSampling2D``) followed by a SAME conv with the OIHW 3x3 ``weight``:
    the JAX module's folded kernel ``K'[a, b]``, the sum of ``K[i, j]`` over
    i in {a-1, a} and j in {b-1, b} (the 2x2 windows of ``K`` padded by one),
    flipped on both spatial axes and with in and out channels swapped, as a
    transposed conv takes it. Summed in ``weight``'s float32, then rounded to
    ``dtype`` once, in ``channels_last`` memory; zero-padded to ``widths``
    (in, out) where given."""
    k4 = F.avg_pool2d(weight, 2, stride=1, padding=1, divisor_override=1)
    k4 = k4.flip(-2, -1).transpose(0, 1)
    return zero_padded(k4, (*(widths or k4.shape[:2]), *k4.shape[2:]), dtype)


class FusedUpsampleConv(Conv):
    """Nearest-x2 upsample followed by a 3x3 conv. Where autograd does not
    record (every predict, the export), it runs as the JAX module runs it:
    one stride-2 transposed 4x4 conv whose kernel is folded from the 3x3
    params on every call (:func:`fold_upsample_kernel`). The two are the same
    function; the transposed conv never writes the upsampled map and takes 4
    taps an output pixel, not 9. Under autograd the upsample and the 3x3 conv
    run as two ops: split over slabs, the transposed conv's backward sums
    its gradients in orders that leave the sharded training step further
    from the one-rank step than ``tests/test_torch_train_spatial.py`` allows.
    The params are a plain 3x3 conv's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled():
            return super().forward(upsample_nearest_2x(x))
        return self.transposed(x, 1)

    def forward_slab(self, x: torch.Tensor, group) -> torch.Tensor:
        """The same on an H slab of ``group``: the slab padded with one row of
        each neighbour (zeros at the image's edges, as the global padding),
        VALID on H. The two ops keep one upsampled halo row a side; the
        transposed conv's padding of 3 rows drops the halo rows' two output
        rows a side besides the global padding's one."""
        x = halo_exchange(x, 1, group)
        if torch.is_grad_enabled():
            return super().forward(upsample_nearest_2x(x)[..., 1:-1, :], valid_h=True)
        return self.transposed(x, (3, 1))

    def transposed(self, x: torch.Tensor, padding=1) -> torch.Tensor:
        """The stride-2 transposed 4x4 conv; ``padding`` as
        ``F.conv_transpose2d``'s (1: the upsample-conv with SAME padding)."""
        tracing.count("upconv.transposed", 1)
        self.count_pad()
        w = fold_upsample_kernel(self.weight, x.dtype, (self.width_in, self.width_out))
        b = zero_padded(self.bias, (self.width_out,), x.dtype)
        return F.conv_transpose2d(x, w, b, stride=2, padding=padding)


def sigmoid_head(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """Conv1x1(1 channel) -> sigmoid as a channel contraction (the JAX
    ``SigmoidHead1x1``), through the head kernel. (B, H, W) float32."""
    taps = zero_padded(conv.weight[0, :, 0, 0], x.shape[1:2], x.dtype)
    return diff_sigmoid_head(x, taps, conv.bias[0])


def diff_head_taps(conv: Conv, x: torch.Tensor):
    """Taps and bias of ``softmax(conv1x1(x))[:, 1] == sigmoid(<x, w> + b)``:
    the difference of the two classes' 1x1 kernels and biases, the taps in
    ``x``'s dtype and zero-padded to its channels."""
    w = conv.weight[:, :, 0, 0]
    return zero_padded(w[1] - w[0], x.shape[1:2], x.dtype), conv.bias[1] - conv.bias[0]


class DilatedUNet(nn.Module):
    """Dilated-bottleneck U-Net; input (B, H, W) or (B, 1, H, W), output
    (B, H, W) float32 class-1 probability, or a dict ``main_out``,
    ``aux_out1``, ``aux_out2`` with deep supervision.

    ``remat`` recomputes the encoder's conv blocks in the backward instead
    of keeping their activations; ``remat_level1`` recomputes the
    full-resolution stages: the down1 block and the level-1 tail (the up1
    stage and the main head). The regions are the JAX module's, run through
    ``torch.utils.checkpoint``; the gradients are the plain path's, bit for
    bit. ``remat_level1_prevent_cse`` is XLA's knob (an optimization
    barrier); it is accepted and has no effect here, where nothing merges
    the replay with the forward.

    ``batch_shard`` (a :class:`~adipose_tpu_torch.parallel.multihost.BatchShard`)
    says which rows of a global batch this process holds: dropout then draws
    the global batch's masks and keeps those rows, so several processes
    together draw what one process draws for the whole batch.

    ``spatial`` (a :class:`~adipose_tpu_torch.parallel.multihost.SlabShard`)
    makes the forward spatially sharded: its input is this process's H slab
    of each tile, and it returns the outputs over the whole tile, on every
    process of ``spatial.group``; the spatial predict
    (:mod:`adipose_tpu_torch.parallel.spatial_unet`) runs it too. Levels 1-2
    on the slab with a 1-row halo a conv, the /4 maps gathered, level 3, the
    bottleneck and up3 replicated, up2 re-sharded by a slice, up1's fused
    upsample-conv on a halo, the heads on the slabs. Gradients follow
    :mod:`adipose_tpu_torch.parallel.collectives`: each process's parameter
    gradients are its slab's share, summed over the processes. So every
    gradient that enters the replicated part is this slab's share only: the
    /4 gather sums its ranks' gradients, and ``aux_out1``, computed on the
    replicated part, is sliced to the slab before it is gathered. The
    ``aux_out2`` map is gathered at /2 and resized whole (the resize clamps
    at the image's edges, not at a halo). Dropout draws every keep-mask for
    the global tensor, in the plain order, and keeps the slab's rows at the
    sharded levels (up2, up1). Slab heights must divide by 4.

    Params are allocated uninitialized: call :meth:`init_params` or load a
    state dict.
    """

    def __init__(self, init_nb: int = 44, dropout_rate: float = 0.3,
                 use_deep_supervision: bool = False,
                 dilation_rates: tuple = (1, 2, 4, 8, 16, 32),
                 compute_dtype: torch.dtype = torch.bfloat16, fast_head: bool = True,
                 remat: bool = False, remat_level1: bool = False,
                 remat_level1_prevent_cse: bool = True, device=None):
        super().__init__()
        nb = init_nb
        self.init_nb = init_nb
        self.dropout_rate = dropout_rate
        self.use_deep_supervision = use_deep_supervision
        self.compute_dtype = compute_dtype
        self.fast_head = fast_head
        self.dilation_rates = tuple(dilation_rates)
        self.remat = remat
        self.remat_level1 = remat_level1
        self.remat_level1_prevent_cse = remat_level1_prevent_cse
        self.batch_shard = None
        self.spatial = None

        def conv(name, cin, cout, k=3, dilation=1, cls=Conv, blocks=1, width_in=None,
                 width_out=None):
            # Inputs and outputs are activations, stored at lane() channels,
            # unless stated: the image and the 1x1 heads' outputs.
            setattr(self, name, cls(cin, cout, k, dilation, device=device, blocks=blocks,
                                    width_in=width_in or lane(cin // blocks),
                                    width_out=width_out or lane(cout)))

        conv("down1_conv1", 1, nb, width_in=1)
        conv("down1_conv2", nb, nb)
        conv("down2_conv1", nb, 2 * nb)
        conv("down2_conv2", 2 * nb, 2 * nb)
        conv("down3_conv1", 2 * nb, 4 * nb)
        conv("down3_conv2", 4 * nb, 4 * nb)
        for i, rate in enumerate(self.dilation_rates):
            conv(f"dilate{i + 1}", 4 * nb if i == 0 else 8 * nb, 8 * nb, dilation=rate)
        for level, feat, below in ((3, 4 * nb, 8 * nb), (2, 2 * nb, 4 * nb), (1, nb, 2 * nb)):
            conv(f"up{level}_conv1", below, feat, cls=FusedUpsampleConv)
            conv(f"up{level}_conv2", 2 * feat, feat, blocks=2)
            conv(f"up{level}_conv3", feat, feat)
        conv("output_softmax", nb, 2, k=1, width_out=2)
        if use_deep_supervision:
            conv("aux_out1", 4 * nb, 1, k=1, width_out=1)
            conv("aux_out2", 2 * nb, 1, k=1, width_out=1)

    def init_params(self, generator: torch.Generator) -> "DilatedUNet":
        """Flax's initialization (lecun_normal kernels, zero biases), drawn
        from ``generator`` in layer order."""
        for m in self.modules():
            if isinstance(m, Conv):
                m.reset_parameters(generator)
        return self

    def _keep_mask(self, shape: torch.Size, generator: torch.Generator | None,
                   device, sharded: bool = False) -> torch.Tensor | None:
        """The dropout keep-mask (``uniform < 1 - rate``) of a (B, C, H, W)
        activation, its uniforms drawn as (B, H, W, C) so the mask shares the
        activation's channels-last layout (with ``batch_shard``: the global
        batch's, sliced to this process's rows; of a ``sharded`` activation
        under ``spatial``: the whole tile's, sliced to the slab's rows), then
        padded with False to the activation's ``lane(C)`` channels; None
        outside training or at rate 0."""
        if not self.training or self.dropout_rate == 0.0:
            return None
        if generator is None:
            raise ValueError("DilatedUNet in training mode needs a generator for dropout")
        b, c, h, w = shape
        shard = self.batch_shard
        slab = self.spatial if sharded else None
        u = torch.rand((b if shard is None else shard.total,
                        h if slab is None else h * slab.count, w, c),
                       generator=generator, device=device)
        if shard is not None:
            u = shard.rows(u)
        if slab is not None:
            u = slab.rows(u, dim=1)
        keep = u < 1.0 - self.dropout_rate
        if lane(c) > c:
            keep = F.pad(keep, (0, lane(c) - c))
        return keep.permute(0, 3, 1, 2)

    def _apply_dropout(self, x: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
        if keep is None:
            return x
        keep_prob = 1.0 - self.dropout_rate
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))

    def _dropout(self, x: torch.Tensor, generator: torch.Generator | None,
                 sharded: bool = False, channels: int | None = None) -> torch.Tensor:
        """Flax ``nn.Dropout``: keep where ``uniform < 1 - rate``, scaled by
        1 / (1 - rate); the identity outside training or at rate 0.
        ``channels``: the activation's own, where ``x`` stores it at more."""
        b, c, h, w = x.shape
        return self._apply_dropout(
            x, self._keep_mask((b, channels or c, h, w), generator, x.device, sharded))

    def _block(self, names: tuple[str, str], x: torch.Tensor) -> torch.Tensor:
        """An encoder ``_ConvBlock``: two Conv3x3-ReLU."""
        for name in names:
            x = F.relu(getattr(self, name)(x))
        return x

    def _slab_block(self, names: tuple[str, str], x: torch.Tensor) -> torch.Tensor:
        """The same on an H slab of ``spatial.group``: each conv VALID on H
        over the slab padded with its neighbours' rows."""
        for name in names:
            conv = getattr(self, name)
            x = F.relu(conv(halo_exchange(x, conv.padding, self.spatial.group), valid_h=True))
        return x

    def _sharded(self, level: int) -> bool:
        """Whether decoder ``level`` runs on H slabs (``spatial``, levels
        1-2)."""
        return self.spatial is not None and level < 3

    @staticmethod
    def _region(remat: bool, fn, *args):
        """``fn(*args)``, recomputed in the backward when ``remat`` is set and
        autograd records. Nothing in a region reads the global RNG (dropout
        takes its keep-masks as inputs), so its state is not kept."""
        if remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def _up_convs(self, level: int, skip: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        conv1 = getattr(self, f"up{level}_conv1")
        names = (f"up{level}_conv2", f"up{level}_conv3")
        if not self._sharded(level):
            y = torch.cat([skip, F.relu(conv1(y))], dim=1)
            return self._block(names, y)
        slab = self.spatial
        if level == 2:  # the replicated upsample-conv, re-sharded by a slice
            y = slab.rows(F.relu(conv1(y)))
        else:  # on the slab, with a 1-row halo
            y = F.relu(conv1.forward_slab(y, slab.group))
        y = torch.cat([skip, y], dim=1).contiguous(memory_format=_CL)
        return self._slab_block(names, y)

    def _to_level1(self, x: torch.Tensor, generator: torch.Generator | None):
        """Everything before the level-1 tail: (down1, up2, up3) in the
        compute dtype, channels-last."""
        if x.dim() == 3:
            x = x.unsqueeze(1)
        x = x.to(self.compute_dtype).contiguous(memory_format=_CL)
        slab = self.spatial
        if slab is None:
            block, pool = self._block, lambda t: F.max_pool2d(t, 2)
        else:
            if x.shape[-2] % 4:
                raise ValueError(f"slab height {x.shape[-2]} must divide by 4: two pools run "
                                 "on the slab")
            block, pool = self._slab_block, spatial_max_pool2
        down1 = self._region(self.remat or self.remat_level1, block,
                             ("down1_conv1", "down1_conv2"), x)
        down2 = self._region(self.remat, block, ("down2_conv1", "down2_conv2"), pool(down1))
        below = pool(down2)
        if slab is not None:  # the /4 maps of the whole tile, on every slab's rank
            below = gather_rows(below, -2, slab.group,
                                sum_grads=True).contiguous(memory_format=_CL)
        down3 = self._region(self.remat, self._block, ("down3_conv1", "down3_conv2"), below)
        d = F.max_pool2d(down3, 2)
        taps = []
        for i in range(len(self.dilation_rates)):
            d = F.relu(getattr(self, f"dilate{i + 1}")(d))
            if i == 0:
                d = self._dropout(d, generator, channels=8 * self.init_nb)
            taps.append(d)
        bottleneck = sum(taps)
        nb = self.init_nb
        up3 = self._dropout(self._up_convs(3, down3, bottleneck), generator, channels=4 * nb)
        up2 = self._dropout(self._up_convs(2, down2, up3), generator, self._sharded(2), 2 * nb)
        return down1, up2, up3

    def _up1_keep(self, down1: torch.Tensor, generator: torch.Generator | None):
        """up1's dropout keep-mask, drawn before the level-1 tail (in the
        order the plain path draws it), so a recompute of the tail reuses it
        and the generator advances once."""
        b, _, h, w = down1.shape
        return self._keep_mask((b, self.init_nb, h, w), generator, down1.device,
                               self._sharded(1))

    def _up1(self, down1: torch.Tensor, up2: torch.Tensor, keep) -> torch.Tensor:
        return self._apply_dropout(self._up_convs(1, down1, up2), keep)

    def _main_head(self, up1: torch.Tensor) -> torch.Tensor:
        # The head kernel reads channels-last. cuDNN returns that layout, so
        # this is a no-op when run; a torch.export trace records the layout
        # the meta functions guess (row-major) unless it is stated here.
        up1 = up1.contiguous(memory_format=_CL)
        if self.fast_head:
            return diff_sigmoid_head(up1, *diff_head_taps(self.output_softmax, up1))
        logits = self.output_softmax(up1)
        return torch.softmax(logits.to(torch.float32), dim=1)[:, 1]

    def _level1_tail(self, down1: torch.Tensor, up2: torch.Tensor, keep) -> torch.Tensor:
        """The up1 stage and the main head: the full-resolution tail as one
        function of (down1, up2), the ``remat_level1`` region."""
        return self._main_head(self._up1(down1, up2, keep))

    def trunk(self, x: torch.Tensor, generator: torch.Generator | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Everything but the heads: the decoder outputs (up1, up2, up3) in
        the compute dtype, channels-last, at ``init_nb`` x (1, 2, 4) channels
        (their padding taken off). ``generator`` draws the dropout masks in
        training mode."""
        down1, up2, up3 = self._to_level1(x, generator)
        up1 = self._up1(down1, up2, self._up1_keep(down1, generator))
        return tuple(t[:, :n * self.init_nb].contiguous(memory_format=_CL)
                     for t, n in ((up1, 1), (up2, 2), (up3, 4)))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        h, w = x.shape[-2:]
        slab = self.spatial
        down1, up2, up3 = self._to_level1(x, generator)
        main = self._region(self.remat_level1, self._level1_tail, down1, up2,
                            self._up1_keep(down1, generator))
        if slab is not None:
            h *= slab.count
            main = gather_rows(main, -2, slab.group)
        if not self.use_deep_supervision:
            return main
        up2, up3 = (t.contiguous(memory_format=_CL) for t in (up2, up3))
        if self.fast_head:
            aux1 = sigmoid_head(self.aux_out1, up3)
            aux2 = sigmoid_head(self.aux_out2, up2)
        else:
            aux1 = torch.sigmoid(self.aux_out1(up3).to(torch.float32))[:, 0]
            aux2 = torch.sigmoid(self.aux_out2(up2).to(torch.float32))[:, 0]
        if slab is not None:
            aux2 = gather_rows(aux2, -2, slab.group)
        aux1 = resize_bilinear(aux1[:, None], (h, w))[:, 0]
        aux2 = resize_bilinear(aux2[:, None], (h, w))[:, 0]
        if slab is not None:  # the slab's share of the replicated head's gradient
            aux1 = gather_rows(slab.rows(aux1).contiguous(), -2, slab.group)
        return {"main_out": main, "aux_out1": aux1, "aux_out2": aux2}


# The phase-1 frozen set (train_adipose_unet_v3.py:761-773).
ENCODER_LAYERS = (
    "down1_conv1", "down1_conv2",
    "down2_conv1", "down2_conv2",
    "down3_conv1", "down3_conv2",
)


def encoder_param_mask(params) -> dict[str, bool]:
    """Trainability of each state-dict entry in phase 1: False for the
    encoder conv layers the reference freezes (``freeze_encoder_layers``,
    :760-775), True for everything else."""
    return {name: name.rsplit(".", 1)[0] not in ENCODER_LAYERS for name in params}
