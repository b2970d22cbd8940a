"""Batched vision serving engine over the fused EfficientNet-B0.

Counterpart of ``repro.serve.vision``.  Requests are admitted into square
resolution buckets (the smallest bucket the longest side fits, zero-padded
up) and launched as fixed-shape ``batch_size`` packs through
``efficientnet_b0_apply``, with each bucket's per-block schedules solved
ONCE and passed into every launch.

* **Admission + load shedding**: a bounded two-level FIFO (a priority
  lane drained ahead of the normal lane; the bound covers both), and
  counted rejections for a full queue or an image above the largest
  bucket.
* **Traffic telemetry**: each launch charges per-(bucket x block)
  counters with the modeled bytes of the schedules it runs.
* **Latency**: per-request latency and queue wait, timed on the host
  clock after ``torch.cuda.synchronize()``.

Counters:

    serve.admitted / serve.admitted.priority
    serve.shed.queue_full / serve.shed.oversize
    serve.batches.r<res> / serve.requests.r<res> / serve.pad_slots.r<res>
    serve.bytes.r<res>.block<NN>   modeled bytes of block NN's schedule
    serve.build.r<res>             ticks when a bucket's schedules are
                                   solved: stays 1 per bucket

Series: ``serve.queue_depth``, ``serve.queue_wait_s``, ``serve.latency_s``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import telemetry
from ..core.autotune import MBConvSchedule
from ..kernels.common import resolve_device
from ..models.mbconv import (
    STEM_STRIDE,
    EffNetConfig,
    efficientnet_b0_apply,
    effnet_schedules,
)

__all__ = [
    "VisionEngine",
    "VisionRequest",
    "VisionResult",
    "VisionServeConfig",
]


@dataclasses.dataclass(frozen=True)
class VisionServeConfig:
    """Admission policy: ascending square ``resolutions`` buckets, the
    fixed ``batch_size`` per launch (short packs pad with zero images),
    and the ``max_queue`` bound above which ``submit`` sheds."""

    resolutions: Tuple[int, ...] = (224, 384, 512)
    batch_size: int = 8
    max_queue: int = 64

    def __post_init__(self):
        if not self.resolutions:
            raise ValueError("need at least one resolution bucket")
        if list(self.resolutions) != sorted(set(self.resolutions)):
            raise ValueError(
                f"resolutions must be strictly ascending, "
                f"got {self.resolutions}")
        if min(self.resolutions) < STEM_STRIDE:
            raise ValueError(f"resolutions must be >= {STEM_STRIDE}")
        if self.batch_size < 1 or self.max_queue < 1:
            raise ValueError("batch_size and max_queue must be >= 1")


@dataclasses.dataclass
class VisionRequest:
    """One admitted request waiting in (or leaving) the queue."""

    rid: int
    image: np.ndarray
    bucket: int                  # admission resolution
    t_submit: float
    priority: int = 0            # > 0 = priority lane (drained first)


@dataclasses.dataclass
class VisionResult:
    """One served request: logits plus the serving story around them."""

    rid: int
    bucket: int
    logits: np.ndarray
    latency_s: float             # submit -> synchronized batch completion
    queue_wait_s: float          # submit -> batch launch


class VisionEngine:
    """Admission-bucketed batched inference over the fused B0.

    ``submit()`` admits (or sheds) one image; ``step()`` launches ONE
    batch — the oldest priority waiter's bucket (else the oldest normal
    waiter's), filled FIFO from the priority lane and back-filled from the
    normal lane; ``drain()`` steps until both lanes are empty.  ``params``
    lie on ``device`` (default CUDA; raises when it is absent).
    """

    def __init__(self, params: dict, cfg: EffNetConfig = EffNetConfig(),
                 serve_cfg: Optional[VisionServeConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.scfg = serve_cfg or VisionServeConfig()
        self._queue: Deque[VisionRequest] = deque()
        self._pqueue: Deque[VisionRequest] = deque()
        self._next_rid = 0
        self._schedules: Dict[int, Tuple[MBConvSchedule, ...]] = {}

    # -- admission -----------------------------------------------------------

    def bucket_for(self, h: int, w: int) -> Optional[int]:
        """Smallest resolution bucket the image fits; None = oversize."""
        side = max(h, w)
        for res in self.scfg.resolutions:
            if side <= res:
                return res
        return None

    def submit(self, image: np.ndarray, priority: int = 0) -> Optional[int]:
        """Admit one (H, W, 3) image.  Returns the request id, or None when
        the request is SHED (queue at bound, or image above the largest
        bucket) — each shed increments its rejection counter."""
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected an (H, W, 3) image, "
                             f"got shape {image.shape}")
        bucket = self.bucket_for(image.shape[0], image.shape[1])
        if bucket is None:
            telemetry.counter("serve.shed.oversize")
            return None
        if self.pending() >= self.scfg.max_queue:
            telemetry.counter("serve.shed.queue_full")
            return None
        rid = self._next_rid
        self._next_rid += 1
        rq = VisionRequest(rid=rid, image=image, bucket=bucket,
                           t_submit=time.perf_counter(), priority=priority)
        (self._pqueue if priority > 0 else self._queue).append(rq)
        telemetry.counter("serve.admitted")
        if priority > 0:
            telemetry.counter("serve.admitted.priority")
        telemetry.record("serve.queue_depth", self.pending())
        return rid

    def pending(self) -> int:
        return len(self._pqueue) + len(self._queue)

    @property
    def shed(self) -> int:
        """Total requests shed so far (both rejection counters)."""
        t = telemetry.get_telemetry()
        return int(t.get("serve.shed.queue_full")
                   + t.get("serve.shed.oversize"))

    # -- per-bucket schedules ------------------------------------------------

    def schedules_for(self, res: int) -> Tuple[MBConvSchedule, ...]:
        """The bucket's per-block schedules: solved once per resolution,
        passed into every launch of that bucket."""
        if res not in self._schedules:
            self._schedules[res] = effnet_schedules(
                self.cfg, self.scfg.batch_size, res, res)
            telemetry.counter(f"serve.build.r{res}")
        return self._schedules[res]

    def modeled_block_bytes(self, res: int) -> Dict[str, int]:
        """Per-launch modeled bytes of one bucket, by block label — the
        increments each launched batch adds to its counters."""
        return {f"block{i:02d}": sch.total_bytes
                for i, sch in enumerate(self.schedules_for(res))}

    # -- serving -------------------------------------------------------------

    def step(self) -> List[VisionResult]:
        """Launch ONE batch (see the class doc); short packs zero-pad."""
        if not self._pqueue and not self._queue:
            return []
        head = self._pqueue[0] if self._pqueue else self._queue[0]
        res = head.bucket
        take: List[VisionRequest] = []
        for lane_name in ("_pqueue", "_queue"):
            lane: Deque[VisionRequest] = getattr(self, lane_name)
            keep: Deque[VisionRequest] = deque()
            for rq in lane:
                if rq.bucket == res and len(take) < self.scfg.batch_size:
                    take.append(rq)
                else:
                    keep.append(rq)
            setattr(self, lane_name, keep)
        return self._launch(res, take)

    def drain(self) -> List[VisionResult]:
        """Step until both lanes are empty; results in completion order."""
        out: List[VisionResult] = []
        while self._pqueue or self._queue:
            out.extend(self.step())
        return out

    def _launch(self, res: int, reqs: List[VisionRequest]
                ) -> List[VisionResult]:
        schedules = self.schedules_for(res)
        batch = np.zeros((self.scfg.batch_size, res, res, 3), np.float32)
        for row, rq in enumerate(reqs):
            h, w = rq.image.shape[:2]
            batch[row, :h, :w, :] = rq.image
        t_launch = time.perf_counter()
        with telemetry.span(f"serve.batch.r{res}"), torch.inference_mode():
            logits = efficientnet_b0_apply(
                self.params, torch.from_numpy(batch).to(self.device),
                self.cfg, schedules=schedules)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        t_done = time.perf_counter()

        telemetry.counter(f"serve.batches.r{res}")
        telemetry.counter(f"serve.requests.r{res}", len(reqs))
        telemetry.counter(f"serve.pad_slots.r{res}",
                          self.scfg.batch_size - len(reqs))
        for layer, total in self.modeled_block_bytes(res).items():
            telemetry.counter(f"serve.bytes.r{res}.{layer}", total)

        arr = logits.cpu().numpy()
        results = []
        for row, rq in enumerate(reqs):
            latency = t_done - rq.t_submit
            wait = t_launch - rq.t_submit
            telemetry.record("serve.latency_s", latency)
            telemetry.record("serve.queue_wait_s", wait)
            results.append(VisionResult(
                rid=rq.rid, bucket=res, logits=arr[row],
                latency_s=latency, queue_wait_s=wait))
        return results

    # -- observability -------------------------------------------------------

    def latency_percentiles(self, qs: Sequence[float] = (50, 90, 99)
                            ) -> Dict[str, float]:
        """Nearest-rank percentiles of every served request's latency."""
        return telemetry.percentiles(telemetry.series("serve.latency_s"), qs)
