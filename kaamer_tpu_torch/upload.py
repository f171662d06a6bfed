"""Host-to-device uploads that do not make the host wait for the card."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def _stage(arrays: Sequence[np.ndarray], pin: bool):
    """The arrays' bytes in one uint8 tensor (pinned when pin), each at an
    8-byte-aligned start, so any element type can view its slice.  Returns
    (tensor, starts)."""
    starts, n = [], 0
    for a in arrays:
        starts.append(n)
        n += -(-a.nbytes // 8) * 8
    staged = torch.empty(max(n, 8), dtype=torch.uint8, pin_memory=pin)
    host = staged.numpy()
    for a, s in zip(arrays, starts):
        host[s:s + a.nbytes] = a.reshape(-1).view(np.uint8)
    return staged, starts


def _views(staged: torch.Tensor, arrays: Sequence[np.ndarray], starts):
    """Each array's slice of staged, as a tensor of its dtype and shape."""
    return [staged[s:s + a.nbytes]
            .view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
            for a, s in zip(arrays, starts)]


def upload_all(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """The numpy arrays as tensors on `device`.

    Copies to a CUDA device are staged together in one pinned host buffer
    and enqueued as one copy with non_blocking=True: one pinned allocation
    and one transfer however many arrays.  A copy from pageable memory
    would run cudaMemcpyAsync and then cudaStreamSynchronize, so the host
    would wait for every kernel already queued on the stream.  torch's
    caching host allocator keeps the pinned buffer alive until the copy
    has run.  On the CPU each tensor shares its array's memory."""
    return upload_each(arrays, [device])[0]


def upload_each(arrays: Sequence[np.ndarray],
                devices) -> List[List[torch.Tensor]]:
    """upload_all to each of `devices`: one list of tensors a device, the
    CUDA ones all copied from one pinned staging buffer."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    staged = None
    out = []
    for device in map(torch.device, devices):
        if device.type != "cuda":
            out.append([torch.from_numpy(a).to(device) for a in arrays])
            continue
        if staged is None:
            staged, starts = _stage(arrays, pin=True)
        out.append(_views(staged.to(device, non_blocking=True), arrays,
                          starts))
    return out


def upload(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array as a tensor on `device` (upload_all)."""
    return upload_all([a], device)[0]
