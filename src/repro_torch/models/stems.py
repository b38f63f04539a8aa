"""Modality stems: Whisper's conv frontend and its FuSe factorization.

Port of ``repro.models.stems``.  The reference conv stem and a
FuSe-factorized variant that puts the paper's operator on an audio stem:

  reference:  conv1d(k=3, mel->d) . gelu . conv1d(k=3, s=2, d->d) . gelu
  FuSe:       pw(mel->d) . fuse1d(k=3) . gelu . fuse1d(k=3, s=2) . pw . gelu

MACs per frame drop from k*d*(mel + d) to d*(mel + 2k + d), the same
K^2->K style factorization as FuSeConv, in 1-D.

``whisper_stem`` is ``F.conv1d`` with XLA's SAME split (the reference runs
a lax conv outside any Pallas kernel).  ``fuse_whisper_stem``'s two
temporal banks are non-causal (centred) and go on the backend's path:
``cuda`` runs each as one launch of the hand ``fuse1d`` kernel, ``torch``
the plain op; the stride-2 bank is computed at full resolution and
subsampled, as in the reference.  Weights keep the reference's layouts:
(K, C_in, C_out) convs, (K, C) banks, (C_in, C_out) pointwise.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import Backend, resolve_backend
from repro_torch.kernels.fused import same_pad
from repro_torch.models.common import dense_init, gelu
from repro_torch.models.recurrent import temporal_conv

Tensor = torch.Tensor


def init_whisper_stem(generator: torch.Generator, n_mels: int, d: int,
                      dtype=torch.float32, device=None) -> dict:
    return {"c1": dense_init(generator, (3, n_mels, d), dtype, device=device),
            "c2": dense_init(generator, (3, d, d), dtype, device=device)}


def _conv_same(x: Tensor, w: Tensor, stride: int) -> Tensor:
    """x (B, T, C_in), w (K, C_in, C_out) -> (B, ceil(T/stride), C_out):
    a lax 'SAME' conv (pad_total // 2 on the low side)."""
    k = w.shape[0]
    _, lo, hi = same_pad(x.shape[1], k, stride)
    y = F.conv1d(F.pad(x.transpose(1, 2), (lo, hi)), w.permute(2, 1, 0),
                 stride=stride)
    return y.transpose(1, 2)


def whisper_stem(p: dict, mel: Tensor) -> Tensor:
    """mel: (B, T, n_mels) -> (B, ceil(T/2), d)."""
    y = gelu(_conv_same(mel, p["c1"], 1))
    return gelu(_conv_same(y, p["c2"], 2))


def init_fuse_whisper_stem(generator: torch.Generator, n_mels: int, d: int,
                           dtype=torch.float32, device=None) -> dict:
    kw = dict(device=device)
    return {"pw_in": dense_init(generator, (n_mels, d), dtype, **kw),
            "t1": dense_init(generator, (3, d), dtype, **kw),
            "t2": dense_init(generator, (3, d), dtype, **kw),
            "pw_out": dense_init(generator, (d, d), dtype, **kw)}


def fuse_whisper_stem(p: dict, mel: Tensor,
                      backend: Union[str, Backend, None] = None) -> Tensor:
    """FuSe-factorized stem, the same (B, ceil(T/2), d) output contract.
    ``backend``: ``"torch"`` (default) or ``"cuda"`` (two ``fuse1d``
    launches)."""
    backend = resolve_backend(backend)
    y = mel @ p["pw_in"]
    y = gelu(temporal_conv(y, p["t1"], backend, causal=False))
    y = temporal_conv(y, p["t2"], backend, causal=False)[:, ::2]
    return gelu(y @ p["pw_out"])


def stem_macs(n_mels: int, d: int, frames: int) -> Tuple[int, int]:
    ref = frames * 3 * n_mels * d + (frames // 2) * 3 * d * d
    fuse = frames * (n_mels * d + 3 * d) + frames * 3 * d + \
        (frames // 2) * d * d
    return ref, fuse
