"""Host streaming of generated maps (BASELINE config 5).

Counterpart of `godotoceanwaves_tpu/utils/streaming.py`. The reference never
reads maps back (textures feed its render pipeline directly); consumers on
the host (encoders, disk, downstream pipelines) get the maps through
`MapStreamer`, which overlaps the device's step k+1 with the copy of step
k's maps to the host.

On a CUDA device each frame's maps are copied into pinned host buffers with
`non_blocking=True` on a side stream, ordered after the producing stream by
an event, so the copy runs while the producing stream computes the next
frame. The link always carries the maps' native dtype: bf16 maps move half
the bytes of an fp32 upcast.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterator

import numpy as np
import torch

from ..models.ocean import OceanMaps

_FIELDS = ("displacement", "normal")


def preview_maps(maps: OceanMaps | None) -> OceanMaps | None:
    """The preview tier: every other texel on both axes, as bf16, on the
    maps' device (a quarter of the full-resolution bf16 bytes). None stays
    None, so a rate-limited step passes through."""
    if maps is None:
        return None
    cut = lambda x: x[..., ::2, ::2].to(torch.bfloat16).contiguous()
    return OceanMaps(displacement=cut(maps.displacement), normal=cut(maps.normal))


class MapStreamer:
    """Overlap device stepping with device-to-host copies of the maps.

    >>> streamer = MapStreamer(lambda: ocean.update(dt))
    >>> for host_maps in streamer.stream(num_frames=100):
    ...     consume(host_maps["displacement"], host_maps["normal"])

    Frames come out in order; a step that returns None (the session's rate
    limiter skipped it) is absorbed, not yielded. At most `max_inflight`
    frames are between their step and their yield.
    """

    def __init__(self, step_fn: Callable[[], OceanMaps | None], max_inflight: int = 2,
                 host_dtype=np.float32):
        """host_dtype: the NumPy dtype the yielded arrays are converted to on
        the host, after the copy (default np.float32, safe for PIL, cv2 and
        encoders). None keeps the maps' native dtype: the yielded values are
        then CPU `torch.Tensor`s, because NumPy has no bfloat16. Either way
        the device-to-host copy moves the native dtype."""
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self._step = step_fn
        self._max_inflight = max_inflight
        self._host_dtype = host_dtype
        self._pinned: dict[int, dict[str, torch.Tensor]] = {}   # slot -> host buffers
        self._copy_stream: torch.cuda.Stream | None = None

    def _host(self, x: torch.Tensor):
        if self._host_dtype is None:
            return x.clone()
        torch_dtype = torch.from_numpy(np.empty(0, self._host_dtype)).dtype
        return x.to(torch_dtype, copy=True).numpy()

    def _start_copy(self, maps: OceanMaps, slot: int):
        """Copy the maps toward the host; returns (host tensors, event or None)."""
        fields = {name: getattr(maps, name).contiguous() for name in _FIELDS}
        dev = fields["displacement"].device
        if dev.type != "cuda":
            return {name: x.detach() for name, x in fields.items()}, None
        host = self._pinned.get(slot)
        if host is None or any(host[k].shape != x.shape or host[k].dtype != x.dtype
                               for k, x in fields.items()):
            host = self._pinned[slot] = {
                k: torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for k, x in fields.items()}
        if self._copy_stream is None or self._copy_stream.device != dev:
            self._copy_stream = torch.cuda.Stream(dev)
        produced = torch.cuda.current_stream(dev).record_event()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(produced)
            for k, x in fields.items():
                host[k].copy_(x, non_blocking=True)
                # the allocator must not hand x's memory to the producer before the copy ends
                x.record_stream(self._copy_stream)
            done = self._copy_stream.record_event()
        return host, done

    def stream(self, num_frames: int) -> Iterator[dict]:
        inflight: collections.deque = collections.deque()
        produced = 0
        while produced < num_frames or inflight:
            while produced < num_frames and len(inflight) < self._max_inflight:
                maps = self._step()
                if maps is None:        # rate-limiter skipped this frame
                    continue
                inflight.append(self._start_copy(maps, produced % self._max_inflight))
                produced += 1
            host, done = inflight.popleft()
            if done is not None:
                done.synchronize()
            # converted (a copy) before the yield, so the pinned slot is free again
            yield {k: self._host(x) for k, x in host.items()}

    def close(self) -> None:
        """Release the pinned buffers and the copy stream."""
        self._pinned.clear()
        self._copy_stream = None
