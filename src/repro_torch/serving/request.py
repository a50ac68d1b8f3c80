"""Serving request/response records."""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Dict, Optional

import numpy as np

_ids = itertools.count()

#: The unified tier vocabulary: every ``Response.tier`` is one of these.
#: ``"satellite"`` — answered by the onboard model W^s (including the
#: single-tier ``InferenceEngine``, which runs the satellite tier, and the
#: link-down graceful-degradation path); ``"ground"`` — offloaded through
#: the Eq. 2/Eq. 3 pipeline and answered by the GS model W^g.
TIERS = ("satellite", "ground")

#: Priority classes (higher = more urgent).  Plain ints so producers can
#: insert intermediate levels; these names are the conventional three the
#: overload bench and the cascade server use.  ``PRIORITY_URGENT`` is the
#: disaster-monitoring / near-real-time class the paper's deployment story
#: needs to keep responsive under saturation.
PRIORITY_BULK = 0
PRIORITY_NORMAL = 1
PRIORITY_URGENT = 2


@dataclasses.dataclass
class Request:
    task: str                       # vqa | cls | det
    image: np.ndarray               # (H, W, C)
    prompt: int                     # class / task prompt id
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    t_arrival: float = 0.0
    max_new_tokens: Optional[int] = None
    #: Identity of the captured scene this request queries.  Queries over
    #: the same scene share image-region work (prefix KV pages in the paged
    #: engine, encode reuse in the serve path).  ``None`` → derived from the
    #: image pixels by ``scene_key``.
    scene_id: Optional[Any] = None
    #: Piggybacked draft answer tokens for speculative decoding — typically
    #: the satellite's already-computed compact-model answer riding the
    #: offload payload (bytes the downlink already carries).  Aligned with
    #: answer positions; purely advisory: wrong drafts cost accept rate,
    #: never correctness (the verifier commits only its own greedy tokens).
    draft_tokens: Optional[np.ndarray] = None
    #: Scheduling priority (higher = more urgent; see ``PRIORITY_*``).  Only
    #: read by overload-controlled engines: plain ``admit_many`` traffic is
    #: FIFO regardless, so the default changes nothing for existing callers.
    priority: int = PRIORITY_BULK
    #: Optional staleness bound in seconds from submission: an overload
    #: queue drops the request (outcome ``"rejected"``, reason
    #: ``"expired"``) instead of admitting it once the answer could no
    #: longer arrive in time.  ``None`` → never expires while queued.
    #: Already-admitted requests always run to completion.
    deadline_s: Optional[float] = None

    def __post_init__(self):
        # Drafts are admission metadata read token-by-token on the host.
        # Normalising to a flat host int32 array HERE (the one-time request
        # boundary) keeps a device array from ever reaching
        # ``_record_admissions`` — which would host-sync in the hot path.
        if self.draft_tokens is not None:
            self.draft_tokens = np.asarray(self.draft_tokens,
                                           np.int32).reshape(-1)


def scene_key(req: Request) -> Any:
    """Stable per-scene key: ``req.scene_id`` when the producer assigned one
    (the satellite knows which capture a query targets), else a content hash
    of the image pixels.  Memoised on the request — admission is a hot path.
    """
    if req.scene_id is not None:
        return req.scene_id
    key = getattr(req, "_scene_key", None)
    if key is None:
        a = np.ascontiguousarray(np.asarray(req.image))
        h = hashlib.sha1(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
        key = req._scene_key = h.hexdigest()
    return key


@dataclasses.dataclass
class Response:
    request_id: int
    tokens: np.ndarray              # (L_ans,)
    pred: Any
    tier: str                       # one of TIERS
    exit_stage: int                 # −1 = answered onboard
    latency_s: float
    tx_bytes: float
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
