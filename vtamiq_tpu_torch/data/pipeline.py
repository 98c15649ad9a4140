"""Host-side input pipeline: split iteration, size-bucketed batching,
threaded prefetch, native batch decode into pinned host tensors.

Port of ``vtamiq_tpu/data/pipeline.py``:

- Per-split knobs (patch count, flips, aligned patches, repeats) are
  immutable loader state; the loader yields whole decoded image batches and
  the steps sample and extract patches on the compute device.
- The epoch's order, flips and batches come from numpy's
  ``np.random.default_rng((seed, epoch))``, drawn exactly as the JAX
  package's loader draws them, so both loaders yield the same batches for
  the same seed.
- Batches form per size: per exact (H, W), or, with ``max_size_buckets`` >
  0, per canonical bucket (``data/buckets.py``) with each image zero-padded
  bottom/right and its true size in ``img_hw``; a group's last partial batch
  is padded by repeating its last item (``valid`` counts the real ones).
- The native decoder (``data/native_io.py``) decodes a batch on a thread
  pool straight into one host tensor, each image in its padded slot; with
  ``pin_memory`` that tensor is pinned, so the engine's
  ``.to(device, non_blocking=True)`` copies it without a staging copy.
- A background thread prefetches batches, so decode overlaps the device.
- Several processes (``process_index`` / ``process_count``: a mesh's data
  rank and data size) walk one global batch schedule in lockstep: every
  process derives the same permutation, flips and bucket grouping from
  (seed, epoch) and decodes only its contiguous slice of each global batch
  of ``batch_size * process_count`` items, so batch counts, bucket shapes
  and the global valid counts agree across processes by construction (a
  strided slice cannot promise that once bucketing or partial batches
  are involved). Ranks that share a data index load the same slice.

HDR data, image caches and datasets that override ``img_pretransform``
decode one sample at a time through ``PatchFRIQADataset.get_sample``, as in
the JAX package; so does a dataset whose format the native build lacks
(``imread`` then needs PIL, or raises).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import namedtuple
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import native_io
from .buckets import assign_bucket, compute_canonical_buckets, pad_to_bucket
from .datasets import PatchFRIQADataset
from ..utils.logging import log_warn

_UNRESOLVED = object()  # sentinel: declared-size verification not yet run

ImageBatch = namedtuple(
    "ImageBatch",
    [
        "qs",        # (B,) float32 tensor of labels
        "imgs_raw",  # (B, K, H, W, 3) float32 tensor in [0,1] (pinned with
                     # pin_memory); the model normalization is fused into
                     # the device step (train/steps.py)
        "indices",   # (B,) int numpy array of dataset indices
        "valid",     # int: first `valid` items are real; rest are pad repeats
        "img_hw",    # (B, 2) int32 tensor of TRUE image sizes when batches
                     # are padded to canonical buckets; else None
        "global_valid",  # several processes: the valid count of the GLOBAL
                         # batch this slice belongs to (the steps' loss
                         # mask); None for one process
    ],
    defaults=(None, None),
)


class PatchDatasetLoader:
    """Iterates one split of a dataset as size-bucketed image batches. The
    patch_* knobs are carried for the device-side extraction to consume
    (``train/steps.py``)."""

    def __init__(self, dataset: PatchFRIQADataset, split_name: str,
                 batch_size: int, patch_count: int,
                 allow_img_flip: bool = False,
                 use_aligned_patches: bool = True,
                 shuffle: bool = False,
                 num_repeats_data: int = 1,
                 img_zero_error_q_prob: float = -1.0,
                 seed: int = 0,
                 prefetch: int = 2,
                 pad_partial_batches: bool = True,
                 max_size_buckets: int = 0,
                 process_index: int = 0,
                 process_count: int = 1,
                 pin_memory: bool = False):
        """``max_size_buckets`` > 0 pads variable-size datasets (LIVE, KADIS)
        to <= that many canonical (H, W) shapes; 0 batches by exact size,
        right for fixed-size datasets (TID, KADID, CSIQ, PIPAL).
        ``pin_memory``: batches in pinned host memory (needs a CUDA build of
        PyTorch). ``process_index`` / ``process_count``: this process's
        slice of global batches of ``batch_size * process_count`` items
        (see the module docstring)."""
        if not dataset.has_split(split_name):
            raise ValueError(f"Dataset {dataset.name} has no split [{split_name}].")
        if not 0 <= int(process_index) < max(1, int(process_count)):
            raise ValueError(f"process_index {process_index} outside [0, {process_count})")
        self.dataset = dataset
        self.split_name = split_name
        self.batch_size = int(batch_size)
        self.patch_count = int(patch_count)
        self.allow_img_flip = bool(allow_img_flip)
        self.use_aligned_patches = bool(use_aligned_patches)
        self.shuffle = bool(shuffle)
        self.num_repeats_data = max(1, int(num_repeats_data))
        self.img_zero_error_q_prob = img_zero_error_q_prob  # carried, unused (as in JAX)
        self.seed = seed
        self.prefetch = max(0, int(prefetch))
        self.pad_partial_batches = pad_partial_batches
        self.max_size_buckets = int(max_size_buckets)
        self.pin_memory = bool(pin_memory)
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))
        self._size_buckets = None  # computed lazily from the split's sizes
        self._epoch = 0
        self._size_cache: Dict[int, Tuple[int, int]] = {}
        self._fixed_size_cache = _UNRESOLVED
        # host seconds spent decoding each batch yielded (producer side)
        self.decode_seconds: List[float] = []

    # -- iteration ----------------------------------------------------------

    def _epoch_indices(self, rng: np.random.Generator) -> np.ndarray:
        base = np.asarray(self.dataset.split_indices(self.split_name))
        reps = [rng.permutation(base) if self.shuffle else base
                for _ in range(self.num_repeats_data)]
        return np.concatenate(reps)

    def __len__(self):
        """Batches per epoch: the sum over size groups of each group's
        ceil (or floor, without padding) division; group counts do not
        depend on the epoch's permutation."""
        reps = self.num_repeats_data
        bs = self.batch_size * self.process_count  # batches assemble globally
        if self._fixed_size() is not None:
            n = len(self.dataset.split_indices(self.split_name))
            if self.pad_partial_batches:
                return (n * reps + bs - 1) // bs
            return (n * reps) // bs
        canonical = self.size_buckets()
        counts: Dict[Tuple[int, int], int] = {}
        for i in self.dataset.split_indices(self.split_name):
            size = self._item_size_cached(int(i))
            if canonical is not None:
                size = assign_bucket(size, canonical)
            counts[size] = counts.get(size, 0) + 1
        if self.pad_partial_batches:
            return sum((c * reps + bs - 1) // bs for c in counts.values())
        return sum((c * reps) // bs for c in counts.values())

    # -- sizes ---------------------------------------------------------------

    def _item_size(self, index: int) -> Tuple[int, int]:
        """(h, w) of one split item from its reference image's header."""
        path = self.dataset.sample_paths(index)[0]
        if native_io.available():
            try:
                return native_io.image_size(path)
            except native_io.CodecUnavailableError:
                pass
        return self.dataset.get_img(path, is_ref_img=True).shape[:2]

    def _fixed_size(self) -> Optional[Tuple[int, int]]:
        """The dataset's declared img_dim, verified against one probed item
        and trusted for every index thereafter; a declaration the first item
        contradicts falls back to per-item probing."""
        if self._fixed_size_cache is _UNRESOLVED:
            declared = self.dataset.img_dim
            if declared is not None:
                indices = self.dataset.split_indices(self.split_name)
                if len(indices):
                    actual = self._item_size(int(indices[0]))
                    if tuple(actual) != tuple(declared):
                        log_warn(
                            f"dataset {self.dataset.name}: declared img_dim "
                            f"{tuple(declared)} != first item's actual size "
                            f"{actual}; falling back to per-item size probes")
                        declared = None
            self._fixed_size_cache = (tuple(declared) if declared is not None
                                      else None)
        return self._fixed_size_cache

    def _item_size_cached(self, index: int) -> Tuple[int, int]:
        fixed = self._fixed_size()
        if fixed is not None:
            return fixed
        size = self._size_cache.get(index)
        if size is None:
            size = self._size_cache[index] = tuple(self._item_size(index))
        return size

    def size_buckets(self) -> Optional[List[Tuple[int, int]]]:
        """The canonical bucket shapes this loader pads to (None when exact
        bucketing is active). Computed once from the split's image sizes."""
        if self.max_size_buckets <= 0:
            return None
        if self._size_buckets is None:
            sizes = [self._item_size_cached(int(i))
                     for i in self.dataset.split_indices(self.split_name)]
            self._size_buckets = compute_canonical_buckets(sizes, self.max_size_buckets)
        return self._size_buckets

    # -- batch assembly ------------------------------------------------------

    def _host_tensor(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.pin_memory)

    def _finish(self, items: List[tuple], imgs_raw: torch.Tensor, valid: int,
                global_valid: Optional[int] = None) -> ImageBatch:
        """items: (index, q, ..., true (h, w)) of the batch, pads included."""
        qs = self._host_tensor((len(items),))
        qs.copy_(torch.tensor([it[1] for it in items], dtype=torch.float32))
        indices = np.asarray([it[0] for it in items], int)
        img_hw = None
        if self.max_size_buckets > 0:
            img_hw = self._host_tensor((len(items), 2), torch.int32)
            img_hw.copy_(torch.tensor([it[-1] for it in items], dtype=torch.int32))
        return ImageBatch(qs, imgs_raw, indices, valid, img_hw, global_valid)

    def _use_native_batch_decode(self) -> bool:
        """The batch decoder serves plain 8-bit datasets; HDR data, image
        caches and datasets overriding the decode-time hook go through
        ``get_sample``."""
        if self.dataset.is_hdr:
            return False
        if self.dataset.use_ref_img_cache or self.dataset.use_dist_img_cache:
            return False
        if type(self.dataset).img_pretransform is not PatchFRIQADataset.img_pretransform:
            return False
        return native_io.available()

    def _decode_native(self, bucket: List[tuple], bucket_hw: Tuple[int, int],
                       valid: Optional[int] = None,
                       global_valid: Optional[int] = None) -> ImageBatch:
        """bucket items: (index, q, paths, (h_flip, v_flip), true (h, w));
        each image decodes into its slot of one (B, K, bh, bw, 3) tensor;
        pad items copy the last real one. A scheduled slice (``valid``
        given) holds batch_size items, its pads decoded as they are."""
        t0 = time.perf_counter()
        if valid is None:
            valid = len(bucket)
        k = len(bucket[0][2])
        bh, bw = bucket_hw
        out = self._host_tensor((self.batch_size, k, bh, bw, 3))
        if any(tuple(it[4]) != (bh, bw) for it in bucket):
            out.zero_()
        base, slot = out.data_ptr(), bh * bw * 3 * out.element_size()
        paths, sizes, ptrs, hflips, vflips = [], [], [], [], []
        for i, (_index, _q, sample_paths, (hf, vf), true_hw) in enumerate(bucket):
            for j, p in enumerate(sample_paths):
                paths.append(p)
                sizes.append(true_hw)
                ptrs.append(base + (i * k + j) * slot)
                hflips.append(hf)
                vflips.append(vf)
        native_io.decode_batch_into(paths, sizes, ptrs, [bw * 3] * len(paths),
                                    h_flips=hflips, v_flips=vflips)
        if len(bucket) < self.batch_size:
            bucket = bucket + [bucket[-1]] * (self.batch_size - valid)
            out[valid:] = out[valid - 1]
        batch = self._finish(bucket, out, valid, global_valid)
        self.decode_seconds.append(time.perf_counter() - t0)
        return batch

    def _produce_native(self, rng) -> Iterator[ImageBatch]:
        canonical = self.size_buckets()
        buckets: Dict[Tuple[int, int], list] = {}
        for index in self._epoch_indices(rng):
            index = int(index)
            paths = self.dataset.sample_paths(index)
            q = float(self.dataset.qs[index])
            h_flip = v_flip = False
            if self.allow_img_flip:
                h_flip = bool(rng.random() < 0.5)
                v_flip = bool(rng.random() < 0.5)
            true_hw = self._item_size_cached(index)
            size = assign_bucket(true_hw, canonical) if canonical is not None else true_hw
            bucket = buckets.setdefault(size, [])
            bucket.append((index, q, paths, (h_flip, v_flip), true_hw))
            if len(bucket) == self.batch_size:
                yield self._decode_native(bucket, size)
                buckets[size] = []
        for size, bucket in buckets.items():
            if bucket and self.pad_partial_batches:
                yield self._decode_native(bucket, size)

    def _make_batch(self, items: List[tuple]) -> ImageBatch:
        """items: (index, q, imgs list, true (h, w)), decoded one by one."""
        t0 = time.perf_counter()
        valid = len(items)
        items = items + [items[-1]] * (self.batch_size - valid)
        stacked = np.stack([np.stack(it[2]) for it in items]).astype(np.float32)
        out = self._host_tensor(stacked.shape)
        out.copy_(torch.from_numpy(stacked))
        batch = self._finish(items, out, valid)
        self.decode_seconds.append(time.perf_counter() - t0)
        return batch

    def _produce_per_sample(self, rng) -> Iterator[ImageBatch]:
        canonical = self.size_buckets()
        buckets: Dict[Tuple[int, int], list] = {}
        for index in self._epoch_indices(rng):
            q, imgs_raw, _ = self.dataset.get_sample(
                int(index), rng=rng, allow_img_flip=self.allow_img_flip,
                compute_norm=False)
            true_hw = tuple(imgs_raw[0].shape[:2])
            if canonical is not None:
                size = assign_bucket(true_hw, canonical)
                if size != true_hw:
                    imgs_raw = [pad_to_bucket(im, size) for im in imgs_raw]
            else:
                size = true_hw
            bucket = buckets.setdefault(size, [])
            bucket.append((int(index), q, imgs_raw, true_hw))
            if len(bucket) == self.batch_size:
                yield self._make_batch(bucket)
                buckets[size] = []
        for size, bucket in buckets.items():
            if bucket and self.pad_partial_batches:
                yield self._make_batch(bucket)

    # -- multi-process lockstep schedule -------------------------------------

    def _epoch_schedule(self, rng) -> List[tuple]:
        """The global batch schedule, the same in every process (the same
        rng draws): (bucket_hw, items, global_valid) per global batch, each
        ``items`` (index, q, (h_flip, v_flip), true_hw) of exactly
        ``batch_size * process_count`` entries (a final partial global batch
        pads by repeating its last item). Only file headers are read here."""
        canonical = self.size_buckets()
        g = self.batch_size * self.process_count
        schedule: List[tuple] = []
        buckets: Dict[Tuple[int, int], list] = {}
        for index in self._epoch_indices(rng):
            index = int(index)
            h_flip = v_flip = False
            if self.allow_img_flip:
                h_flip = bool(rng.random() < 0.5)
                v_flip = bool(rng.random() < 0.5)
            true_hw = self._item_size_cached(index)
            size = assign_bucket(true_hw, canonical) if canonical is not None else true_hw
            bucket = buckets.setdefault(size, [])
            bucket.append((index, float(self.dataset.qs[index]), (h_flip, v_flip), true_hw))
            if len(bucket) == g:
                schedule.append((size, bucket, g))
                buckets[size] = []
        for size, bucket in buckets.items():
            if bucket and self.pad_partial_batches:
                valid = len(bucket)
                schedule.append((size, bucket + [bucket[-1]] * (g - valid), valid))
        return schedule

    def _decode_slice(self, items: List[tuple], bucket_hw: Tuple[int, int], valid: int,
                      global_valid: int) -> ImageBatch:
        """Decode this process's scheduled items, pads included, one sample
        at a time, flipping as the schedule drew."""
        t0 = time.perf_counter()
        per_item = []
        for index, _q, (hf, vf), _true_hw in items:
            _, raws, _ = self.dataset.get_sample(index, rng=None, allow_img_flip=False,
                                                 compute_norm=False)
            sample = []
            for im in raws:
                if hf:
                    im = im[:, ::-1]
                if vf:
                    im = im[::-1]
                im = np.ascontiguousarray(im)
                if self.max_size_buckets > 0 and im.shape[:2] != tuple(bucket_hw):
                    im = pad_to_bucket(im, bucket_hw)
                sample.append(im)
            per_item.append(np.stack(sample))
        stacked = np.stack(per_item).astype(np.float32)
        out = self._host_tensor(stacked.shape)
        out.copy_(torch.from_numpy(stacked))
        batch = self._finish(items, out, valid, global_valid)
        self.decode_seconds.append(time.perf_counter() - t0)
        return batch

    def _produce_scheduled(self, rng) -> Iterator[ImageBatch]:
        """Every process walks the same schedule and decodes its contiguous
        slice of each global batch. ``valid`` is the slice's leading-valid
        count (the global pads are a suffix of the global batch);
        ``global_valid`` feeds the steps' loss mask. A format the native
        build lacks shows on the first batch, and the epoch then decodes
        sample by sample, as with one process."""
        b, p = self.batch_size, self.process_index
        native = self._use_native_batch_decode()
        for k, (bucket_hw, items, gvalid) in enumerate(self._epoch_schedule(rng)):
            local = items[p * b:(p + 1) * b]
            lvalid = int(np.clip(gvalid - p * b, 0, b))
            if native:
                try:
                    yield self._decode_native(
                        [(index, q, self.dataset.sample_paths(index), flips, true_hw)
                         for index, q, flips, true_hw in local], bucket_hw, lvalid, gvalid)
                    continue
                except native_io.CodecUnavailableError as e:
                    if k:
                        raise
                    log_warn(f"loader {self.dataset.name}/{self.split_name}: {e}; "
                             "decoding sample by sample")
                    native = False
            yield self._decode_slice(local, bucket_hw, lvalid, gvalid)

    def _produce(self) -> Iterator[ImageBatch]:
        epoch = self._epoch
        self._epoch += 1
        rng = np.random.default_rng((self.seed, epoch))
        if self.process_count > 1:
            yield from self._produce_scheduled(rng)
            return
        if self._use_native_batch_decode():
            # a format the native build lacks shows on the first batch; the
            # epoch then restarts on the per-sample path (PIL, or a raise).
            # Later errors propagate: a restart would repeat yielded samples
            gen = self._produce_native(rng)
            try:
                first = next(gen)
            except StopIteration:
                return
            except native_io.CodecUnavailableError as e:
                log_warn(f"loader {self.dataset.name}/{self.split_name}: {e}; "
                         "decoding sample by sample")
                rng = np.random.default_rng((self.seed, epoch))
            else:
                yield first
                yield from gen
                return
        yield from self._produce_per_sample(rng)

    def __iter__(self) -> Iterator[ImageBatch]:
        if self.prefetch <= 0:
            yield from self._produce()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error_holder: list = []
        stop = threading.Event()

        def worker():
            try:
                for batch in self._produce():
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer side
                error_holder.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # a consumer that stops early (an exception in the step) must
            # not leave the producer blocked on a full queue
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if error_holder:
            raise error_holder[0]
