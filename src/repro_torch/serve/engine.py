"""The continuous-batching inference engine (counterpart of
``repro.serve.engine``).

``ServeEngine`` turns one parameter tree into a request-level server:

* a fixed pool of KV-cache slots, partitioned into size buckets
  (``scheduler.BucketSpec``); per bucket a chunked **prefill** (forward
  + cache writeback) and a **decode** step with per-slot positions, whose
  cache read is the ``flash_decode`` kernel on the card. On the card
  each bucket's decode step, greedy ``argmax`` included, is **one CUDA
  graph**, the counterpart of the reference's one compiled decode
  program a bucket;
* requests are admitted into free slots mid-flight; the decode step
  always runs the full bucket batch (inactive rows compute ignored
  garbage, as in the reference);
* every per-step device-to-host pull is one ``(batch,)`` token vector.

Prefill runs the whole bucket batch, as the reference's does (the rows
of a moe batch share the experts' capacity, so the batch is part of
the function), and keeps the new cache only for the admitted slots.
The port writes caches in place, so it prefills a copy of the bucket's
cache and copies the admitted slots' rows back: the running slots' k, v
are never touched. Weights are cast to the activation dtype once, at
construction (the reference casts them in every step; the numbers are
the same), except the norms' and the moe router's, which the model
reads in fp32.

The decode graph (:meth:`ServeEngine._decode`) is captured on the
bucket's first decode: that tick runs eagerly on a side stream (the
warm-up PyTorch's graph docs ask for; a decode step written twice at
the same positions writes the same values, so the warm-up is the
tick), then the step is captured on that stream, so the ``flash_decode``
merge counters it uses are the ones its replays use. Every later tick
copies the bucket's tokens and positions into the graph's static
buffers and replays it. A capture or a replay that fails raises; the
engine never falls back to eager decode on the card. On the CPU decode
stays eager.

``ImageClassifier`` is the stateless analogue for the paper's CNN
classifiers: per-batch-bucket scoring over padded image batches.

:meth:`ServeEngine.compile_counts` is the reference's census: per
bucket the distinct prefill chunk shapes run, and the decode graphs
captured (on the CPU, the distinct decode shapes run); 1 and 1 in
steady state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import flash_decode as k_decode
from repro_torch.models.attention import raw_view
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model
from repro_torch.serve.scheduler import BucketSpec, Request, SlotScheduler
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map

SERVE_FAMILIES = ("dense", "moe")


# ------------------------------------------------------------------ results


@dataclass
class ServeResult:
    rid: int
    tokens: List[int]
    prompt_len: int
    bucket: str
    t_submit: float
    t_admit: float
    t_first: float
    t_done: float

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @property
    def ttft(self) -> float:
        """Time to first token (queue wait + prefill)."""
        return self.t_first - self.t_submit


# ------------------------------------------------------------- cache slots


def _batch_axis(t: torch.Tensor) -> int:
    """KV leaves are (B, S, KV, hd), or (n_periods, B, S, KV, hd) under
    the scanned layout (batch second)."""
    return 0 if t.dim() <= 4 else 1


def _merge_slots(cache, rows, idx: torch.Tensor) -> None:
    """Copy the slots ``idx`` of ``rows`` (a prefilled copy of the
    cache) back into the cache; the other slots keep theirs. Through
    ``uint8`` views for an fp8 cache."""
    def merge(t, r):
        ax = _batch_axis(t)
        raw_view(t).index_copy_(ax, idx, raw_view(r).index_select(ax, idx))
    tree_map(merge, cache, rows)


def serving_params(params, dtype: torch.dtype):
    """The parameter tree as the model reads it at ``dtype``: every
    floating leaf cast once, except the norms' and the moe router's
    (read in fp32; a bf16 router would change top-k choices)."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: tree[k] if k.endswith("_norm") or k == "router" else cast(tree[k])
                    for k in tree}
        if isinstance(tree, list):
            return [cast(t) for t in tree]
        return tree.to(dtype) if tree.is_floating_point() else tree
    return cast(params)


# ------------------------------------------------------------------ engine


class _BucketState:
    """Host-side mirror of one bucket's device pool."""

    def __init__(self, model: Model, spec: BucketSpec, device: torch.device):
        self.spec = spec
        self.cache = model.init_cache(spec.batch, spec.seq, device)
        self.pos = np.zeros(spec.batch, np.int32)
        self.last_tok = np.zeros(spec.batch, np.int32)
        self.active = np.zeros(spec.batch, bool)
        self.gen: List[List[int]] = [[] for _ in range(spec.batch)]
        self.req: List[Optional[Request]] = [None] * spec.batch
        self.prefill_shapes: set = set()     # chunk shapes prefill ran
        self.decode_shapes: set = set()      # input shapes eager decode ran (CPU)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tok_in = self.pos_in = self.tok_out = None   # the graph's static tensors
        self.graph_k3 = 0                    # flash_decode calls the graph holds


class ServeEngine:
    """Continuous-batching LM server over a fixed slot pool.

    Parameters
    ----------
    model, params : the served model (the ``dense`` and ``moe``
        families, which have a chunked-prefill path) and its parameter
        tree.
    buckets : the ``BucketSpec`` pool layout.
    prefill_chunk : split each bucket's prefill into chunks of this many
        positions (0, or a width that does not divide the prompt
        ceiling: one chunk of the full ceiling).
    device : where the pool and the params live; ``cuda`` unless given.
    """

    def __init__(self, model: Model, params, buckets: Sequence[BucketSpec], *,
                 prefill_chunk: int = 0, clock=time.perf_counter, device=None):
        cfg = model.cfg
        if cfg.family not in SERVE_FAMILIES or model.prefill is None:
            raise ValueError(
                f"ServeEngine serves attention-backed LMs {SERVE_FAMILIES}; "
                f"got family '{cfg.family}' (ssm/hybrid/encdec/vlm serve via "
                "the per-token repro_torch.launch.serve path)")
        self.device = resolve_device(device)
        if cfg.cache_ring and cfg.sliding_window:
            # ring caches clamp the slot axis to the window; prefill
            # writes [0, prompt_ceiling) contiguously, so prompts must
            # fit the ring (generation may still wrap past it)
            buckets = tuple(BucketSpec(b.batch, b.seq,
                                       prompt_ceiling=min(b.seq, cfg.sliding_window))
                            for b in buckets)
        self.model = model
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device),
                               serving_params(params, dtype_of(cfg.dtype)))
        self.prefill_chunk = prefill_chunk
        self.clock = clock
        self.scheduler = SlotScheduler(buckets)
        self.state = [_BucketState(model, b, self.device) for b in self.scheduler.buckets]
        self.results: Dict[int, ServeResult] = {}
        self.n_prefill_calls = 0
        self.n_decode_calls = 0
        self._graph_stream = None             # where decode graphs are captured

    # -- device work ----------------------------------------------------

    def _chunk(self, P: int) -> int:
        C = self.prefill_chunk
        return C if (0 < C < P and P % C == 0) else P

    @torch.no_grad()
    def _prefill(self, bs: _BucketState, slots: List[int], toks: np.ndarray,
                 last_idx: np.ndarray) -> np.ndarray:
        """Chunked prefill of the bucket batch (the padded prompts ``toks``
        (batch, P), the admitted ``slots``' rows filled) into a copy of the
        cache, of which the admitted slots' rows are kept; returns each
        row's argmax at its ``last_idx``, the admitted slots' first
        generated tokens."""
        P = toks.shape[1]
        C = self._chunk(P)
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        toks_t = torch.as_tensor(toks, device=self.device)
        last_t = torch.as_tensor(last_idx, dtype=torch.long, device=self.device)
        rows = tree_map(torch.clone, bs.cache)
        tok = torch.zeros(toks.shape[0], dtype=torch.int32, device=self.device)
        for ci in range(P // C):
            chunk = toks_t[:, ci * C:(ci + 1) * C]
            bs.prefill_shapes.add(tuple(chunk.shape))
            logits, rows = self.model.prefill(self.params, chunk, rows, ci * C)
            rel = last_t - ci * C
            in_chunk = (rel >= 0) & (rel < C)
            safe = rel.clamp(0, C - 1)
            row = torch.gather(logits, 1, safe[:, None, None].expand(-1, 1, logits.shape[-1]))
            tok = torch.where(in_chunk, torch.argmax(row[:, 0], dim=-1).to(torch.int32), tok)
        _merge_slots(bs.cache, rows, idx)
        return tok.cpu().numpy()

    def _decode_step(self, bs: _BucketState, tok: torch.Tensor, pos: torch.Tensor):
        """One decode step of the bucket on its cache (written in place):
        the greedy next token of every row, (batch,) int32."""
        logits, bs.cache = self.model.decode_step(self.params, tok, bs.cache, pos)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    @torch.no_grad()
    def _decode(self, bs: _BucketState) -> np.ndarray:
        """One decode tick of the bucket: eager on the CPU; on the card the
        bucket's graph replayed, captured on the bucket's first tick."""
        tok = torch.from_numpy(bs.last_tok)[:, None]
        pos = torch.from_numpy(bs.pos)
        if self.device.type != "cuda":
            bs.decode_shapes.add((tuple(tok.shape), tuple(pos.shape)))
            return self._decode_step(bs, tok, pos).numpy()
        if bs.graph is None:
            return self._capture_decode(bs, tok, pos)
        bs.tok_in.copy_(tok)
        bs.pos_in.copy_(pos)
        bs.graph.replay()
        k_decode.count_replay(bs.graph_k3)
        return bs.tok_out.cpu().numpy()

    def _capture_decode(self, bs: _BucketState, tok: torch.Tensor, pos: torch.Tensor):
        """The bucket's first decode tick: run it eagerly on the capture
        stream (the warm-up), then capture the same step into the
        bucket's graph. Returns the tick's tokens."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        stream = self._graph_stream
        bs.tok_in = tok.to(self.device)
        bs.pos_in = pos.to(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            out = self._decode_step(bs, bs.tok_in, bs.pos_in).cpu().numpy()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        captured = k_decode.flash_decode.captured
        with torch.cuda.graph(graph, stream=stream):
            bs.tok_out = self._decode_step(bs, bs.tok_in, bs.pos_in)
        bs.graph = graph
        bs.graph_k3 = k_decode.flash_decode.captured - captured
        return out

    # -- request flow ----------------------------------------------------

    def submit(self, req: Request) -> None:
        req.t_submit = self.clock()
        self.scheduler.submit(req)

    def _finish(self, bi: int, slot: int) -> None:
        bs = self.state[bi]
        req = self.scheduler.release(bi, slot)
        req.t_done = self.clock()
        self.results[req.rid] = ServeResult(
            rid=req.rid, tokens=list(bs.gen[slot]), prompt_len=req.prompt_len,
            bucket=bs.spec.name, t_submit=req.t_submit, t_admit=req.t_admit,
            t_first=req.t_first, t_done=req.t_done)
        bs.active[slot] = False
        bs.req[slot] = None
        bs.gen[slot] = []
        bs.pos[slot] = 0
        bs.last_tok[slot] = 0

    def _append_token(self, bi: int, slot: int, tok: int) -> None:
        bs = self.state[bi]
        req = bs.req[slot]
        bs.gen[slot].append(int(tok))
        bs.last_tok[slot] = tok
        if len(bs.gen[slot]) >= req.max_new_tokens or \
                (req.eos_id >= 0 and int(tok) == req.eos_id):
            self._finish(bi, slot)

    def step(self) -> None:
        """One engine tick: admit queued requests (a prefill per bucket
        with admissions), then one decode step for every bucket with
        active slots."""
        for bi, lst in self.scheduler.admit().items():
            bs = self.state[bi]
            toks = np.zeros((bs.spec.batch, bs.spec.prompt_ceiling), np.int32)
            last_idx = np.zeros(bs.spec.batch, np.int32)
            for slot, req in lst:
                toks[slot, :req.prompt_len] = req.prompt
                last_idx[slot] = req.prompt_len - 1
                bs.req[slot] = req
                bs.gen[slot] = []
            tok = self._prefill(bs, [slot for slot, _ in lst], toks, last_idx)
            self.n_prefill_calls += 1
            now = self.clock()
            for slot, req in lst:
                req.t_admit = now
                req.t_first = now
                bs.active[slot] = True
                bs.pos[slot] = req.prompt_len
                self._append_token(bi, slot, tok[slot])

        for bi, bs in enumerate(self.state):
            if not bs.active.any():
                continue
            nxt = self._decode(bs)
            self.n_decode_calls += 1
            for slot in np.flatnonzero(bs.active.copy()):
                bs.pos[slot] += 1
                self._append_token(bi, int(slot), nxt[slot])

    def run_until_drained(self, max_ticks: int = 1_000_000) -> None:
        for _ in range(max_ticks):
            if self.scheduler.idle:
                return
            self.step()
        raise RuntimeError(f"not drained after {max_ticks} ticks")

    def compile_counts(self) -> Dict[str, Dict[str, int]]:
        """Per bucket: the distinct prefill chunk shapes run, and the
        decode graphs captured (on the CPU the distinct decode shapes
        run); exactly 1 and 1 in steady state, as the reference's
        compiled-program census."""
        return {bs.spec.name: {"prefill": len(bs.prefill_shapes),
                               "decode": int(bs.graph is not None) if self.device.type == "cuda"
                               else len(bs.decode_shapes)}
                for bs in self.state}


# -------------------------------------------------------- CNN scoring path


@dataclass
class ClassifyResult:
    rid: int
    label: int
    confidence: float
    bucket: str
    t_submit: float
    t_done: float

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class ImageClassifier:
    """Batched image-classification scoring for the paper's CNN clients:
    requests drain in batch buckets (pad to the bucket, forward, argmax
    and softmax confidence)."""

    def __init__(self, model: Model, params, batch_buckets: Sequence[int] = (1, 4, 8), *,
                 clock=time.perf_counter, device=None):
        if model.cfg.family != "cnn":
            raise ValueError(f"ImageClassifier needs a cnn family model, "
                             f"got '{model.cfg.family}'")
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self.clock = clock
        self.results: Dict[int, ClassifyResult] = {}
        self._input_shapes = {b: set() for b in self.buckets}

    @torch.no_grad()
    def _score(self, images: np.ndarray):
        logits, _ = self.model.forward(self.params,
                                       {"images": torch.as_tensor(images, device=self.device)})
        probs = torch.softmax(logits.float(), dim=-1)
        return (torch.argmax(logits, dim=-1).cpu().numpy(),
                torch.max(probs, dim=-1).values.cpu().numpy())

    def _pick_bucket(self, n: int) -> int:
        fits = [b for b in self.buckets if b <= n]
        return max(fits) if fits else self.buckets[0] if n else 0

    def classify(self, requests: Sequence[Request]) -> List[ClassifyResult]:
        """Drain a queue of image requests in bucket-sized groups (the
        largest bucket the remaining queue fills; the tail pads the
        smallest bucket)."""
        queue = list(requests)
        now = self.clock()
        for r in queue:
            r.t_submit = now
        out: List[ClassifyResult] = []
        i = 0
        while i < len(queue):
            remaining = len(queue) - i
            b = self._pick_bucket(remaining)
            if b == 0:
                break
            group = queue[i:i + min(b, remaining)]
            imgs = np.stack([r.image for r in group])
            if len(group) < b:                    # pad the tail group
                pad = np.zeros((b - len(group),) + imgs.shape[1:], imgs.dtype)
                imgs = np.concatenate([imgs, pad])
            self._input_shapes[b].add((imgs.shape, imgs.dtype.str))
            label, conf = self._score(imgs)
            t_done = self.clock()
            for j, r in enumerate(group):
                r.t_done = t_done
                res = ClassifyResult(rid=r.rid, label=int(label[j]), confidence=float(conf[j]),
                                     bucket=f"b{b}", t_submit=r.t_submit, t_done=t_done)
                self.results[r.rid] = res
                out.append(res)
            i += len(group)
        return out

    def compile_counts(self) -> Dict[str, int]:
        """Per bucket, the distinct input shapes it scored: the
        reference's count of programs compiled for the bucket. Eager
        scoring compiles none, so this counts what the reference would
        compile: 1 for a bucket used at one image shape, 0 for a bucket
        never used."""
        return {f"b{b}": len(shapes) for b, shapes in self._input_shapes.items()}
