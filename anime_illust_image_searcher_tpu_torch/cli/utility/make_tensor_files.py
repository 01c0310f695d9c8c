"""Offline preprocessing: decode + pad + resize images to .npy arrays
(reference: utility/make_tensor_files.py — it torch.saves post-transform tensors).

A copy of the JAX package's cli/utility/make_tensor_files.py. The saved artifact
is the *uint8* resized RGB image (HWC .npy), 4x smaller than the reference's f32
CHW tensors; normalization and the BGR swap run on the device at tagging time
(models/tagger.py), so the preprocessing contract can't drift between this tool
and the live decoder. Decode goes through the native decoder when it builds
(``data.ingest.decode_rgb_square``), with Pillow's bytes.

    python -m anime_illust_image_searcher_tpu_torch.cli.utility.make_tensor_files
        --dir D [D2 ...] --dirbase BASE --dest DEST

Mirrors directory structure below ``--dirbase`` into ``--dest`` like the reference
(utility/make_tensor_files.py:164-177). Consumed by ``cli.tagging_pre``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import sys
from typing import List, Optional

import numpy as np

from ...config import DEFAULT_CONFIG
from ...data.ingest import decode_rgb_square, list_files_recursive
from ...utils.errors import format_error, print_traceback
from ...utils.progress import ProgressMeter

WORKER_NUM = 8
PROGRESS_INTERVAL = 100


class Predictor:
    def __init__(self) -> None:
        self.args: Optional[argparse.Namespace] = None
        self.size = DEFAULT_CONFIG.tagger.image_size

    def save_array(self, arr: np.ndarray, file_path: str) -> bool:
        save_path = file_path.replace(self.args.dirbase[0], self.args.dest[0]) + ".npy"
        try:
            path_dir = os.path.dirname(save_path)
            if not os.path.exists(path_dir):
                os.makedirs(path_dir, exist_ok=True)
            np.save(save_path, arr)
            return True
        except Exception as e:  # noqa: BLE001 — disk full / permissions: the
            # file must count as FAILED, not converted
            print(format_error(e))
            print_traceback()
            return False

    def convert_one(self, file_path: str) -> bool:
        try:
            arr = decode_rgb_square(file_path, self.size, pad_to_square=True)
            if arr is None:
                return False
            return self.save_array(arr, file_path)
        except Exception as e:  # noqa: BLE001
            print(f"Failed to convert image to tensor: {file_path}")
            print(e)
            return False

    def process_directory(self, dir_path: str) -> None:
        file_list = list_files_recursive(dir_path)
        print(f"{len(file_list)} files found")
        meter = ProgressMeter(PROGRESS_INTERVAL)
        with concurrent.futures.ThreadPoolExecutor(max_workers=WORKER_NUM) as ex:
            for ok in ex.map(self.convert_one, file_list):
                if not ok:
                    print("Failed to convert image to tensor")
                    continue
                meter.add(1)
        meter.report()


def main(arg_str: List[str]) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", nargs="*", required=True, help="convert target directory")
    parser.add_argument("--dest", nargs=1, required=True, help="tensor file ouput directory")
    parser.add_argument("--dirbase", nargs=1, required=True, help="ignored directory structure part")
    args = parser.parse_args(arg_str)

    predictor = Predictor()
    predictor.args = args
    for path in args.dir:
        predictor.process_directory(path)


if __name__ == "__main__":
    main(sys.argv[1:])
