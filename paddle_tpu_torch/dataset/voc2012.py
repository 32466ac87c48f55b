"""VOC2012 segmentation dataset.

Parity: python/paddle/dataset/voc2012.py (reader_creator:44 — yields
(image CHW uint8, label HW uint8) pairs from the SegmentationClass split
lists). Decodes the real VOCtrainval tar when present under DATA_HOME;
deterministic learnable synthetic blobs otherwise (zero-egress).
"""

import io
import tarfile

import numpy as np

from .common import data_file, _rng

N_CLASSES = 21          # 20 object classes + background
VOC_TAR = "VOCtrainval_11-May-2012.tar"
_SETS_DIR = "VOCdevkit/VOC2012/ImageSets/Segmentation/"
_IMG_DIR = "VOCdevkit/VOC2012/JPEGImages/"
_LBL_DIR = "VOCdevkit/VOC2012/SegmentationClass/"


def _real_reader_creator(tar_path, sub_name):
    from .image import load_image_bytes

    def reader():
        with tarfile.open(tar_path) as tf:
            names = tf.extractfile(_SETS_DIR + sub_name + ".txt")
            ids = [l.strip() for l in
                   io.TextIOWrapper(names).read().splitlines() if l.strip()]
            for img_id in ids:
                img = load_image_bytes(
                    tf.extractfile(_IMG_DIR + img_id + ".jpg").read())
                lbl = load_image_bytes(
                    tf.extractfile(_LBL_DIR + img_id + ".png").read(),
                    is_color=False)[:, :, 0]
                yield img.transpose(2, 0, 1), lbl.astype(np.uint8)

    return reader


def _synthetic_reader_creator(num, seed, size=64):
    """Blob scenes: each image contains one colored rectangle whose class
    drives both its color and the mask labels — segmenters can fit it."""

    def reader():
        rng = _rng(seed)
        colors = _rng(2012).randint(64, 255, (N_CLASSES, 3))
        for _ in range(num):
            cls = int(rng.randint(1, N_CLASSES))
            img = rng.randint(0, 48, (size, size, 3)).astype(np.uint8)
            lbl = np.zeros((size, size), np.uint8)
            h, w = rng.randint(size // 4, size // 2, 2)
            y, x = rng.randint(0, size - h), rng.randint(0, size - w)
            img[y:y + h, x:x + w] = np.clip(
                colors[cls].astype(np.int32) +
                rng.randint(-16, 16, (h, w, 3)), 0, 255).astype(np.uint8)
            lbl[y:y + h, x:x + w] = cls
            yield img.transpose(2, 0, 1), lbl

    return reader


def _reader(sub_name, num, seed):
    tar = data_file(VOC_TAR, f"voc2012/{VOC_TAR}")
    if tar:
        return _real_reader_creator(tar, sub_name)
    return _synthetic_reader_creator(num, seed)


def train():
    return _reader("trainval", 120, seed=81)


def test():
    return _reader("train", 40, seed=82)


def val():
    return _reader("val", 40, seed=83)
