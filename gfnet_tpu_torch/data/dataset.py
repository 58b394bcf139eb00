"""Host-side dataset + batch loader.

Re-implements `datasets/homography_dataset_large_size.py:30-229`: per-dataset
file lists (vis_ir_drone with random modality swap + 100px border crop,
googlemap with bottom crop, glunet offline pairs with stored H json + mask),
online random-homography synthesis, imagenet normalization — then batches to
NHWC numpy, which the train step moves to the device (the analogue of
torchrun's per-rank DataLoader; per-process file-list sharding covers
multi-host). An own copy of the JAX package's `data/dataset.py`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

import numpy as np
from PIL import Image

from gfnet_tpu_torch.data.augment import Compose, glunet_transforms, real_dataset_transforms
from gfnet_tpu_torch.data.homography_synth import random_homography_pair

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _load_rgb(path: str) -> Image.Image:
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return img


class HomographyDataset:
    """Training/validation pairs (ref `HomographyDataset`)."""

    def __init__(
        self,
        dataset: str,
        mode: str = "train",
        data_path: str = "data",
        input_resolution: tuple[int, int] = (448, 448),
        deformation_ratio=(0.3,),
        bi: bool = True,
        normalize: bool = True,
        transforms: Compose | None = None,
        max_items: int | None = None,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.mode = mode
        self.input_resolution = input_resolution
        self.deformation_ratio = tuple(deformation_ratio)
        self.bi = bi
        self.normalize = normalize
        self.rng = np.random.default_rng(seed + process_index)
        if transforms is None and mode == "train":
            transforms = (
                glunet_transforms() if "glunet" in dataset else real_dataset_transforms()
            )
        self.transforms = transforms

        imgs0: list[str] = []
        imgs1: list[str] = []
        self.H_paths: list[str] | None = None
        self.mask_paths: list[str] | None = None

        if mode == "train":
            if dataset == "vis_ir_drone":  # ref `:59-70`
                path = f"{data_path}/train/VIS-IR-drone"
                test_list = set(
                    open(f"{path}/test_list_original.txt").read().split("\n")
                )
                all_list = sorted(os.listdir(f"{path}/train/trainimg/"))
                train_list = [x for x in all_list if x not in test_list][:5000]
                for name in train_list:
                    if self.rng.uniform() > 0.5:  # random modality swap
                        imgs0.append(f"{path}/train/trainimg/{name}")
                        imgs1.append(f"{path}/train/trainimgr/{name}")
                    else:
                        imgs0.append(f"{path}/train/trainimgr/{name}")
                        imgs1.append(f"{path}/train/trainimg/{name}")
            elif dataset == "googlemap":  # ref `:71-80`
                path = f"{data_path}/train/GoogleMap"
                train_list = sorted(os.listdir(f"{path}/map/"))[:5000]
                for name in train_list:
                    if self.rng.uniform() > 0.5:
                        imgs0.append(f"{path}/satellite/{name}")
                        imgs1.append(f"{path}/map/{name}")
                    else:
                        imgs0.append(f"{path}/map/{name}")
                        imgs1.append(f"{path}/satellite/{name}")
            elif dataset == "glunet_448x448_occlusion":  # ref `:81-91`
                path = f"{data_path}/train/glunet_448x448_occlusion/target"
                train_list = sorted(
                    os.path.join(path, p) for p in os.listdir(path)
                )
                self.H_paths, self.mask_paths = [], []
                for image_path in train_list:
                    name = os.path.basename(image_path)
                    imgs0.append(image_path)
                    imgs1.append(image_path.replace("target", "source"))
                    self.mask_paths.append(image_path.replace("target", "mask"))
                    self.H_paths.append(
                        image_path.replace("target", "H_s2t").replace("jpg", "json")
                    )
            else:
                raise ValueError(f"unknown train dataset {dataset}")
        elif mode == "val":
            # dir-driven test sets (ref `:92-119`, `test.py:41-55`). The
            # reference is self-inconsistent about googlemap-224: test.py:51
            # (the canonical eval entry) uses `googlemap_1k_224x224_new`,
            # homography_dataset_large_size.py:106 the un-suffixed name —
            # accept whichever layout exists, preferring test.py's.
            candidates = {
                "vis_ir_drone": ["visir_1k_448x448"],
                "googlemap": ["googlemap_1k_448x448_new"],
                "googlemap_224x224": ["googlemap_1k_224x224_new", "googlemap_1k_224x224"],
                "googlemap_672x672": ["googlemap_1k_672x672"],
                "mscoco": ["mscoco_1k_448x448"],
                # this engine's synthetic benchmark dirs (exact GT H; written
                # by tools/make_synth_valdir.py in the same layout)
                "synthetic": ["synth_1k_448x448"],
                "synthetic_crossmodal": ["synth_1k_448x448_cm"],
                "synthetic_tiny": ["synth_1k_112x112"],
            }[dataset]
            subdir = next(
                (c for c in candidates if os.path.isdir(f"{data_path}/test/{c}")),
                candidates[0],
            )
            path = f"{data_path}/test/{subdir}/target"
            test_list = sorted(os.listdir(path))
            self.H_paths = [
                os.path.join(path.replace("target", "H_s2t"), os.path.splitext(p)[0] + ".json")
                for p in test_list
            ]
            imgs0 = [os.path.join(path, p) for p in test_list]  # target
            imgs1 = [os.path.join(path.replace("target", "source"), p) for p in test_list]
        else:
            raise ValueError(mode)

        # multi-host sharding of the file list
        imgs0 = imgs0[process_index::process_count]
        imgs1 = imgs1[process_index::process_count]
        if self.H_paths:
            self.H_paths = self.H_paths[process_index::process_count]
        if max_items:
            imgs0, imgs1 = imgs0[:max_items], imgs1[:max_items]
            if self.H_paths:
                self.H_paths = self.H_paths[:max_items]
        self.imgs0, self.imgs1 = imgs0, imgs1

    def __len__(self) -> int:
        return len(self.imgs0)

    def _border_crop(self, a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if self.dataset == "vis_ir_drone":  # ref `:149-157`
            return a[100:-100, 100:-100], b[100:-100, 100:-100]
        if self.dataset == "googlemap":  # ref `:158-166`
            return a[:-100, :], b[:-100, :]
        return a, b

    def __getitem__(self, index: int) -> dict[str, Any]:
        img0 = _load_rgb(self.imgs0[index])  # target-side list
        img1 = _load_rgb(self.imgs1[index])  # source-side list

        if self.mode == "train":
            a0, a1 = self._border_crop(np.asarray(img0), np.asarray(img1))
            img0, img1 = Image.fromarray(a0), Image.fromarray(a1)
            if self.transforms is not None:
                img0 = self.transforms(img0, self.rng)
                img1 = self.transforms(img1, self.rng)
            arr0 = np.asarray(img0, np.float32) / 255.0
            arr1 = np.asarray(img1, np.float32) / 255.0
            if "glunet" not in self.dataset:
                dr = float(self.rng.choice(self.deformation_ratio))
                crop_size = int(self.input_resolution[0] / (1 - dr))
                # randomH warps the (img0, img1) pair; returns (src, tgt, H)
                src, tgt, H_s2t = random_homography_pair(
                    arr0, arr1, crop_size, self.input_resolution, dr, self.bi, self.rng
                )
            else:
                with open(self.H_paths[index]) as f:
                    H_s2t = np.asarray(json.load(f)["H"], np.float32)
                src, tgt = arr1, arr0  # offline pairs: source/target dirs
            sample = {
                "im_A": self._norm(src),
                "im_B": self._norm(tgt),
                "H_s2t": H_s2t.astype(np.float32),
            }
            if self.mask_paths is not None:
                mask = np.asarray(Image.open(self.mask_paths[index]), np.float32) / 255.0
                sample["mask"] = mask
            return sample

        # val: resize to input resolution, rescale stored H (ref `:192-209`)
        w0, h0 = img0.size
        w1, h1 = img1.size
        res = self.input_resolution[0]
        img0 = img0.resize((res, res), Image.BICUBIC)
        img1 = img1.resize((res, res), Image.BICUBIC)
        with open(self.H_paths[index]) as f:
            H = np.asarray(json.load(f)["H"], np.float32)
        S0 = np.diag([res / w0, res / h0, 1.0]).astype(np.float32)
        S1 = np.diag([res / w1, res / h1, 1.0]).astype(np.float32)
        H_s2t = S1 @ H @ np.linalg.inv(S0)
        return {
            "im_A": np.asarray(img1, np.float32) / 255.0,  # source raw [0,1]
            "im_B": np.asarray(img0, np.float32) / 255.0,  # target raw [0,1]
            "H_s2t": H_s2t,
            "im_A_path": self.imgs1[index],
            "im_B_path": self.imgs0[index],
        }

    def _norm(self, x: np.ndarray) -> np.ndarray:
        if not self.normalize:
            return x
        return (x - IMAGENET_MEAN) / IMAGENET_STD


_WORKER_DS: HomographyDataset | None = None


def _loader_worker_init(dataset: HomographyDataset, seed: int) -> None:
    global _WORKER_DS
    _WORKER_DS = dataset
    # distinct augmentation/synthesis stream per worker process
    dataset.rng = np.random.default_rng([seed, os.getpid()])


def _loader_worker_get(index: int) -> dict[str, Any]:
    return _WORKER_DS[index]


class BatchLoader:
    """Prefetching batch iterator over worker PROCESSES.

    The reference uses 8 DataLoader worker processes (`train.py:123-133`);
    a thread pool can't match that here because the per-sample work (PIL
    decode + augmentation + cv2 homography warp) is GIL-heavy. Worker
    processes decode/augment/warp in parallel while `prefetch` whole batches
    are kept in flight, so the accelerator never waits on the host pipeline
    (measured: scripts/profile_loader.py). num_workers=0 degrades to
    synchronous in-process loading (CI/smoke-friendly).
    """

    def __init__(
        self,
        dataset: HomographyDataset,
        batch_size: int,
        num_workers: int = 8,
        seed: int = 0,
        prefetch: int = 2,
        drop_keys: tuple[str, ...] = ("im_A_path", "im_B_path"),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_keys = drop_keys
        self.pool = None
        if num_workers > 0:
            import multiprocessing as mp

            # spawn: never fork a process that already initialized CUDA
            ctx = mp.get_context("spawn")
            self.pool = ctx.Pool(
                num_workers, initializer=_loader_worker_init,
                initargs=(dataset, seed),
            )

    def _stack(self, samples: list[dict]) -> dict[str, np.ndarray]:
        return {
            k: np.stack([s[k] for s in samples])
            for k in samples[0]
            if k not in self.drop_keys
        }

    def batches(self, num_batches: int) -> Iterator[dict[str, np.ndarray]]:
        n = len(self.dataset)

        def draw():
            return self.rng.choice(n, size=self.batch_size, replace=False)

        if self.pool is None:
            for _ in range(num_batches):
                yield self._stack([self.dataset[i] for i in draw()])
            return

        from collections import deque

        pending: deque = deque()
        submitted = 0
        while submitted < min(self.prefetch + 1, num_batches):
            pending.append(self.pool.map_async(_loader_worker_get, draw()))
            submitted += 1
        for _ in range(num_batches):
            samples = pending.popleft().get()
            if submitted < num_batches:
                pending.append(self.pool.map_async(_loader_worker_get, draw()))
                submitted += 1
            yield self._stack(samples)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None
