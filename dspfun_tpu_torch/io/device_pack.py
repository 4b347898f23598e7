"""Device-side frame packing: RGB float frames -> container payload
bytes on the frames' device (PyTorch port of
``dspfun_tpu/io/device_pack.py:make_packer``).

The frame-emitting tools (scan, zoom) copy every frame to the host.
Float RGB costs 12 bytes a pixel even when the container stores 3
(yuv444p y4m) or 1 (gray).  Packing on the device (YCbCr matrix, chroma
box filter, range quantisation to uint8/uint16, planar layout) cuts the
copy 4-12x and takes the writers' per-frame numpy conversion off the
host.  PERF.md has what that is worth on an H100.

The payload equals the host writers' ``rgb_to_planes`` +
``_quantize_plane`` bytes up to float32-vs-float64 rounding at exact .5
boundaries (<= 1 level; tests/test_torch_video_fvid.py), and the JAX
packer's likewise.

Plain PyTorch: the JAX original is XLA code, not a Pallas kernel.
``pack_motion_planes`` is not ported: the port's motion CLI quantises
its 8-bit output on the device its own way (tools/motion.py).
"""

from __future__ import annotations

import torch

from dspfun_tpu_torch.io import color as _color

__all__ = ["make_packer"]


def _bytes(q: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ...] -> [n, S] little-endian payload bytes."""
    return q.reshape(n, -1).contiguous().view(torch.uint8)


def make_packer(pf, props, height: int, width: int):
    """A ``frames [F, H, W, 3] float RGB tensor -> [F, S] uint8 payload
    tensor`` function for the pixel format ``pf`` (io/video.PixelFormat)
    and color properties ``props``, on the frames' device; or None when
    the format has no packed path (callers keep the host writer path).

    Supported: 8/16-bit gray and planar YCbCr (with chroma subsampling)
    and float gbrp/gray (layout reorder only).  The bytes of a row are
    the container's frame payload: planes in order, little-endian.
    """
    from dspfun_tpu_torch.io.video import _matrix_for  # noqa: PLC0415

    def luma(f):
        return 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]

    if pf.is_float:
        if pf.is_rgb:       # gbrpf32le: planar G, B, R
            def pack_gbrp(frames):
                f = frames.to(torch.float32)
                n = f.shape[0]
                return _bytes(torch.stack([f[..., 1], f[..., 2], f[..., 0]], dim=1), n)

            return pack_gbrp
        if pf.ncomp == 1:   # grayf32le
            def pack_grayf(frames):
                f = frames.to(torch.float32)
                return _bytes(luma(f), f.shape[0])

            return pack_grayf
        return None

    maxv = (1 << pf.depth) - 1
    scale8 = 1 << (pf.depth - 8)
    mpeg = props.color_range == "mpeg"

    def quant(p, chroma):
        if mpeg:
            v = (p * (224.0 if chroma else 219.0) + 16.0) * scale8
        else:
            v = p * maxv
        q = torch.clamp(torch.round(v), 0, maxv)
        if pf.depth <= 8:
            return q.to(torch.uint8)
        # 0..65535 as the low 16 bits of an int32: the same two bytes
        # as a uint16, on every device (uint16 has few kernels)
        return q.to(torch.int32).to(torch.int16)

    if pf.ncomp == 1:       # gray / gray16le
        def pack_gray(frames):
            f = frames.to(torch.float32)
            return _bytes(quant(luma(f), False), f.shape[0])

        return pack_gray

    if not pf.name.startswith("yuv"):
        return None

    m = _color.ycbcr_matrix(_matrix_for(props.color_space)).astype("float32")
    sx, sy = pf.chroma_shift
    fx, fy = 1 << sx, 1 << sy
    ph, pw = (height + fy - 1) // fy, (width + fx - 1) // fx

    def pack_yuv(frames):
        f = frames.to(torch.float32)
        n = f.shape[0]
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        # three planes, one fused row of the matrix each: no [F, H, W, 3]
        # intermediate beside the frame
        y, cb, cr = (float(m[k, 0]) * r + float(m[k, 1]) * g + float(m[k, 2]) * b
                     for k in range(3))
        cb = cb + 0.5
        cr = cr + 0.5
        if sx or sy:
            def down(p):
                pad = torch.nn.functional.pad(
                    p[:, None], (0, pw * fx - width, 0, ph * fy - height),
                    mode="replicate")[:, 0]
                return pad.reshape(n, ph, fy, pw, fx).mean(dim=(2, 4))

            cb, cr = down(cb), down(cr)
        return torch.cat([_bytes(quant(y, False), n), _bytes(quant(cb, True), n),
                          _bytes(quant(cr, True), n)], dim=1)

    return pack_yuv
