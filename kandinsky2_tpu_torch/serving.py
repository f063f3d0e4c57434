"""Serving runtime: warmup, request queue, dynamic micro-batching and LoRA
hot-swap, the counterpart of ``kandinsky2_tpu/serving.py``.

* ``GenerationServer.warmup(shapes)`` runs every (kwargs, batch-bucket)
  pair once, so the first user requests find the kernels built and the
  allocator's pools grown.
* Requests enqueue; one device-owner thread drains the queue and groups
  requests with identical shape keys into ONE batched pipeline call: the
  pipelines take a list of *distinct* prompts, so different users'
  requests share a call (CFG-doubled on the card).
* Coalesced batches round up to power-of-two buckets (1, 2, 4, ...
  max_batch) by repeating the last prompt (and image and mask), so the
  UNet sees 2, 4 or 8 rows; surplus images are dropped on the host.
* ``text2img``, ``img2img`` and ``inpainting`` coalesce across users
  (init images and masks ride per batch row, keyed by shape and mode only,
  never content).  Arrays, tensors or PIL images inside free-form
  ``**kwargs`` are rejected at submit time: per-request content goes
  through ``image=`` / ``image_mask=``, so it cannot poison the batching
  key.
* Backpressure through a bounded queue; clean shutdown.
* LoRA hot-swap: ``attach_lora(name, loras)`` registers an adapter (the
  factor dict of ``models.lora``: {state-dict name: {"down", "up"}}) and
  requests select it with ``submit(..., lora=name)``.  On an adapter
  switch the device-owner thread restores the pristine weights snapshotted
  at attach time and folds the new factors into them
  (``models.lora.merge_lora``: W + s·(down @ up)ᵀ, same shapes), so the
  base is bitwise exact after any number of swaps.  The JAX package folds
  every weight in one compiled program (``_get_fold_kernels``), because
  XLA's asynchronous dispatch would otherwise queue hundreds of fp32
  temporaries; eagerly, one weight at a time is the counterpart, and the
  transient is one fp32 weight.  The adapter name is part of the batch
  key, so the rows of one call always share one set of weights.

* Over a tensor-parallel pipeline (``pipeline.shard()``: one process per
  rank, each rank serving the same requests in the same order) every rank
  must make the same calls, or the ranks would meet in different
  collectives and hang: coalescing by timing differs from rank to rank.
  So rank 0 of ``pipeline.mesh`` forms each batch by timing as above and
  broadcasts it (the requests' submission numbers) over the mesh; the
  other ranks run exactly those requests, taking them from their own
  queues.  Rank 0 broadcasts an empty batch while idle and a stop when it
  stops; the other ranks' workers end on that stop.  A sharded weight
  takes its slice of an adapter's factors at attach time
  (``parallel.tensor_parallel.local_lora``).  (The JAX package runs one
  process over the mesh, so its server needs none of this.)

Device work stays on one thread (one stream owner); the host side is
thread-safe.
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .models.lora import merge_lora
from .parallel.tensor_parallel import local_lora


def _content_descriptor(v) -> Optional[Tuple]:
    """Shape/dtype (or PIL size/mode) descriptor for per-request content
    (a numpy array, a tensor or a PIL image): what batching may key on.
    Returns None for plain static values."""
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return ("arr", tuple(v.shape), str(v.dtype))
    if hasattr(v, "size") and hasattr(v, "mode"):  # PIL.Image
        return ("pil", tuple(v.size), str(v.mode))
    return None


@dataclass
class _Request:
    prompt: str
    kwargs: Dict[str, Any]
    task: str = "text2img"
    image: Any = None
    image_mask: Any = None
    lora: Optional[str] = None
    future: Future = field(default_factory=Future)
    seq: int = -1  # submission number (the batch a sharded server broadcasts)

    @property
    def coalescable(self) -> bool:
        # all three tasks batch: the pipelines take per-row init images AND
        # per-row masks, so distinct users' content shares one call
        return self.task in ("text2img", "img2img", "inpainting")

    def shape_key(self) -> Tuple:
        # all **kwargs are shape and schedule parameters for every pipeline
        # version (h/w/num_steps for 2.x, decoder_steps/prior_steps for 2.2);
        # requests batch together only when the call is identical but for
        # its prompts.  Per-request content (init image, mask) contributes
        # shape/mode, never content: each batch row takes its own image and
        # mask.
        parts = [("task", self.task), ("lora", self.lora)]
        if self.image is not None:
            parts.append(("image", _content_descriptor(self.image)))
        if self.image_mask is not None:
            parts.append(("image_mask", _content_descriptor(self.image_mask)))
        parts.extend(sorted((k, str(v)) for k, v in self.kwargs.items()))
        return tuple(parts)


class GenerationServer:
    """Micro-batching front end over a Kandinsky pipeline.

    >>> server = GenerationServer(pipe, max_batch=4)
    >>> server.start(); fut = server.submit("a red cat", h=768, w=768)
    >>> images = fut.result()
    """

    def __init__(self, pipeline, max_batch: int = 4, max_queue: int = 64,
                 batch_window_s: float = 0.02):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "coalesced": 0,
                       "padded": 0, "errors": 0, "lora_swaps": 0}
        # adapter registry: name -> (loras, scale, module); pristine base
        # weights snapshotted per (module, name) the first time any adapter
        # targets them; the currently folded adapter + its fold recipe (kept
        # separately so a detach can't strand folded weights)
        self._lora_lock = threading.Lock()
        self._loras: Dict[str, Tuple[dict, float, str]] = {}
        self._pristine: Dict[Tuple[str, str], torch.Tensor] = {}
        self._active_lora: Optional[str] = None
        self._folded: Optional[Tuple[dict, float, str]] = None
        # a tensor-parallel pipeline: every rank runs rank 0's batches
        self._mesh = getattr(pipeline, "mesh", None)
        self._seq = itertools.count()
        self._held: Dict[int, _Request] = {}

    def stats(self) -> Dict[str, float]:
        """Serving counters since start: requests served, device batches
        issued, requests that shared a batch with another user, padding rows
        spent rounding to buckets, errors, current queue depth, and the
        coalescing ratio (requests per device batch)."""
        with self._stats_lock:
            s = dict(self._stats)
        s["queue_depth"] = self._queue.qsize()
        s["coalesce_ratio"] = (
            s["requests"] / s["batches"] if s["batches"] else 0.0)
        return s

    # ------------------------------------------------------------------
    # LoRA hot-swap

    def _weights(self, module: str) -> Dict[str, torch.nn.Parameter]:
        return dict(self.pipeline.models()[module].named_parameters())

    def attach_lora(self, name: str, loras: dict, *, scale: float = 1.0,
                    module: str = "unet") -> None:
        """Register a LoRA adapter (``models.lora`` factor dict:
        {state-dict name: {"down", "up"}}) of ``pipeline.models()[module]``
        under ``name``; requests opt in with ``submit(..., lora=name)``.
        Every newly targeted weight is snapshotted here (a clone on its
        device), so later folds start from the true base whatever the swap
        history; the factors move to their weight's device.  Nothing
        changes the model until a request selects the adapter."""
        if not loras:
            raise ValueError("empty LoRA factor dict")
        with self._lora_lock:
            weights = self._weights(module)
            unknown = sorted(set(loras) - set(weights))
            if unknown:
                raise KeyError(f"LoRA targets not in {module}: {unknown[:5]}")
            for n in loras:
                key = (module, n)
                if key not in self._pristine:
                    # not yet snapshotted => never folded => pristine
                    self._pristine[key] = weights[n].detach().clone()
            on_device = {n: local_lora(weights[n], {k: v.to(weights[n].device)
                                                    for k, v in f.items()})
                         for n, f in loras.items()}
            self._loras[name] = (on_device, float(scale), module)

    def detach_lora(self, name: str) -> None:
        """Remove an adapter from the registry.  If it is currently folded
        it stays folded until the next request with a different (or no)
        adapter triggers the usual restore; the fold recipe is kept
        internally, so detaching can never strand adapted weights."""
        with self._lora_lock:
            del self._loras[name]

    @torch.no_grad()
    def _ensure_lora(self, name: Optional[str]) -> None:
        """Device-owner thread only: make ``name`` the folded adapter.
        Restores the pristine weights of whatever is folded now, then folds
        the requested adapter into its pristine weights, one weight at a
        time (restore-then-merge: exact, no accumulation over swaps)."""
        if name == self._active_lora:
            return
        with self._lora_lock:
            if self._folded is not None:
                loras, _, module = self._folded
                weights = self._weights(module)
                for n in loras:
                    weights[n].copy_(self._pristine[(module, n)])
                self._folded = None
            if name is not None:
                entry = self._loras[name]
                loras, scale, module = entry
                weights = self._weights(module)
                for n, f in loras.items():
                    base = self._pristine[(module, n)]
                    weights[n].copy_(merge_lora({n: base}, {n: f}, scale)[n])
                self._folded = entry
            self._active_lora = name
        with self._stats_lock:
            self._stats["lora_swaps"] += 1

    # ------------------------------------------------------------------

    def _buckets(self) -> List[int]:
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return out

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets():
            if n <= b:
                return b
        return self.max_batch

    def warmup(self, shapes: List[dict]) -> None:
        """Run every (kwargs, batch-bucket) pair once: the kernels build at
        first use and the allocator grows its pools.  An entry may carry
        ``task="img2img"`` / ``task="inpainting"`` to warm those paths (a
        black init image / all-ones mask of the requested size is used)."""
        for kw in shapes:
            kw = dict(kw)
            task = kw.pop("task", "text2img")
            for b in self._buckets():
                prompts = ["warmup"] * b
                if task in ("img2img", "inpainting"):
                    from PIL import Image

                    img = Image.new("RGB", (kw.get("w", 512), kw.get("h", 512)))
                    if task == "inpainting":
                        mask = np.ones(
                            (kw.get("h", 512), kw.get("w", 512)), np.float32
                        )
                        self.pipeline.generate_inpainting(
                            prompts, [img] * b, [mask] * b, batch_size=b, **kw
                        )
                    else:
                        self.pipeline.generate_img2img(
                            prompts, [img] * b, batch_size=b, **kw
                        )
                else:
                    self.pipeline.generate_text2img(prompts, batch_size=b, **kw)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def submit(
        self, prompt: str, *, task: str = "text2img", image=None,
        image_mask=None, lora: Optional[str] = None, **kwargs,
    ) -> Future:
        """Enqueue a generation request; returns a Future of list[PIL.Image].

        ``task``: "text2img" (default), "img2img" (requires ``image``), or
        "inpainting" (requires ``image`` + ``image_mask``; coalesces like
        the others — masks ride per-row).  ``lora``: name of an adapter
        previously registered with :meth:`attach_lora`; the worker folds it
        into the base weights before the batch runs (requests with the same
        adapter coalesce; different adapters never share a call).
        Per-request content goes through ``image=`` / ``image_mask=`` only:
        arrays, tensors or PIL images hiding in other kwargs are rejected
        because their content cannot participate in the batch key."""
        if task not in ("text2img", "img2img", "inpainting"):
            raise ValueError(f"unsupported serving task: {task!r}")
        if lora is not None:
            with self._lora_lock:
                if lora not in self._loras:
                    raise KeyError(
                        f"unknown LoRA adapter {lora!r}; attach_lora first")
        if task != "text2img" and image is None:
            raise ValueError(f"task={task!r} requires image=")
        if task == "inpainting" and image_mask is None:
            raise ValueError("task='inpainting' requires image_mask=")
        for k, v in kwargs.items():
            if _content_descriptor(v) is not None:
                raise TypeError(
                    f"array/PIL kwarg {k!r} is not batchable; pass "
                    "per-request content via image= / image_mask="
                )
        req = _Request(
            prompt=prompt, kwargs=kwargs, task=task, image=image,
            image_mask=image_mask, lora=lora, seq=next(self._seq),
        )
        self._queue.put(req)
        return req.future

    # ------------------------------------------------------------------

    def _collect_batch(self) -> List[_Request]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        if not first.coalescable:
            return batch
        deadline = threading.Event()
        deadline.wait(self.batch_window_s)
        key = first.shape_key()
        leftovers = []
        while len(batch) < self.max_batch:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req.shape_key() == key:
                batch.append(req)
            else:
                leftovers.append(req)
        for req in leftovers:
            self._queue.put(req)
        return batch

    def _broadcast_batch(self, batch: Optional[List[_Request]]) -> List[int]:
        """Rank 0 of the mesh sends its batch's submission numbers ([]
        while idle, None to stop); every rank returns them ([-1] for a
        stop)."""
        mesh = self._mesh
        msg = torch.full((self.max_batch + 1,), -2, dtype=torch.int64)
        if batch is None:
            msg[0] = -1
        elif batch:
            msg[0] = len(batch)
            msg[1:len(batch) + 1] = torch.tensor([r.seq for r in batch])
        else:
            msg[0] = 0
        if mesh.backend == "nccl":
            msg = msg.cuda()
        dist.broadcast(msg, src=mesh.ranks[0], group=mesh.group)
        n = int(msg[0])
        return [-1] if n < 0 else [int(s) for s in msg[1:n + 1]]

    def _take(self, seq: int, timeout: float = 600.0) -> _Request:
        """This rank's request number ``seq``, from the queue where it has
        not been drawn yet."""
        while seq not in self._held:
            req = self._queue.get(timeout=timeout)
            self._held[req.seq] = req
        return self._held.pop(seq)

    def _lockstep_worker(self) -> None:
        """The worker over a tensor-parallel pipeline (module docstring)."""
        lead = dist.get_rank() == self._mesh.ranks[0]
        while True:
            if lead:
                stopping = self._stop.is_set()
                batch = None if stopping else self._collect_batch()
                seqs = self._broadcast_batch(batch)
            else:
                seqs = self._broadcast_batch([])
                batch = [self._take(s) for s in seqs if s >= 0]
            if seqs == [-1]:
                return
            if batch:
                self._run_batch(batch)

    def _worker(self) -> None:
        if self._mesh is not None:
            return self._lockstep_worker()
        while not self._stop.is_set():
            batch = self._collect_batch()
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch: List[_Request]) -> None:
        try:
            # one pipeline call serves the whole batch, distinct prompts
            # included; pad to the warmed bucket so coalesced sizes 3,
            # 5, 6... run at the 4- and 8-wide shapes
            task = batch[0].task
            kw = batch[0].kwargs
            self._ensure_lora(batch[0].lora)
            with self._stats_lock:
                self._stats["requests"] += len(batch)
                self._stats["batches"] += 1
                if len(batch) > 1:
                    self._stats["coalesced"] += len(batch)
                if batch[0].coalescable:
                    self._stats["padded"] += (
                        self._bucket_for(len(batch)) - len(batch))
            b = self._bucket_for(len(batch))
            prompts = [r.prompt for r in batch]
            prompts += [prompts[-1]] * (b - len(batch))
            if task == "inpainting":
                inits = [r.image for r in batch]
                inits += [inits[-1]] * (b - len(batch))
                masks = [r.image_mask for r in batch]
                masks += [masks[-1]] * (b - len(batch))
                images = self.pipeline.generate_inpainting(
                    prompts, inits, masks, batch_size=b, **kw
                )
            elif task == "img2img":
                inits = [r.image for r in batch]
                inits += [inits[-1]] * (b - len(batch))
                images = self.pipeline.generate_img2img(
                    prompts, inits, batch_size=b, **kw
                )
            else:
                images = self.pipeline.generate_text2img(
                    prompts, batch_size=b, **kw
                )
            for req, img in zip(batch, images):
                req.future.set_result([img])
        except Exception as e:  # pragma: no cover - error propagation
            with self._stats_lock:
                self._stats["errors"] += 1
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
