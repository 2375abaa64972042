"""Serving: continuous-batching LM inference with ``flash_decode`` on the
decode path, and batched CNN scoring (counterpart of ``repro.serve``)."""
from repro_torch.serve.api import classify, generate, make_engine, reduce_clients  # noqa: F401
from repro_torch.serve.engine import (ClassifyResult, ImageClassifier,  # noqa: F401
                                      ServeEngine, ServeResult)
from repro_torch.serve.scheduler import (BucketSpec, Request,  # noqa: F401
                                         SlotScheduler, default_bucket_layout)
