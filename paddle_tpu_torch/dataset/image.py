"""Image pre-processing utilities.

Parity: python/paddle/dataset/image.py (resize_short:197, to_chw:225,
center_crop:249, random_crop:277, left_right_flip:305,
simple_transform:327, load_and_transform:383, batch_images_from_tar:80).
Notes: pure numpy (+ PIL for codec work — cv2 is not required); all transforms return float32/uint8 HWC numpy arrays until to_chw,
matching the reference's contract so model recipes keep identical shapes.
"""

import io
import os
import tarfile

import numpy as np


def _pil():
    try:
        from PIL import Image
        return Image
    except Exception as e:  # pragma: no cover - PIL is in the image
        raise ImportError(f"PIL unavailable for image decoding: {e}")


def load_image_bytes(data, is_color=True):
    """Decode an encoded (jpeg/png/...) byte string to an HWC uint8 array."""
    img = _pil().open(io.BytesIO(data))
    img = img.convert("RGB" if is_color else "L")
    arr = np.asarray(img)
    if not is_color:
        arr = arr[:, :, None] if arr.ndim == 2 else arr
    return arr


def load_image(path, is_color=True):
    with open(path, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def _resize(im, h, w):
    """Bilinear resize via PIL (codec-quality), numpy in/out. Preserves
    dtype: float images resize per-channel in PIL 'F' mode (no value
    truncation), uint8 goes through the native path."""
    Image = _pil()
    squeeze = im.ndim == 3 and im.shape[2] == 1
    src = im[:, :, 0] if squeeze else im
    dtype = src.dtype
    if dtype == np.uint8:
        out = np.asarray(Image.fromarray(src).resize((w, h)))
    else:
        chans = src[..., None] if src.ndim == 2 else src
        planes = [np.asarray(Image.fromarray(
            chans[:, :, c].astype(np.float32), mode="F").resize((w, h)))
            for c in range(chans.shape[2])]
        out = np.stack(planes, axis=-1)
        if src.ndim == 2:
            out = out[:, :, 0]
    if squeeze:
        out = out[:, :, None]
    return out.astype(dtype)


def resize_short(im, size):
    """Scale so the SHORTER edge becomes `size`, keeping aspect ratio."""
    h, w = im.shape[:2]
    if h < w:
        nh, nw = size, int(round(w * size / float(h)))
    else:
        nh, nw = int(round(h * size / float(w))), size
    return _resize(im, nh, nw)


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0, w0 = (h - size) // 2, (w - size) // 2
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = np.random.randint(0, h - size + 1)
    w0 = np.random.randint(0, w - size + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short -> crop (random+flip when training, center otherwise)
    -> CHW float32 -> optional mean subtraction (scalar, per-channel, or
    full-image mean array, as the reference accepts)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 2:
        im = im[:, :, None]
    im = to_chw(im).astype("float32")
    if mean is not None:
        mean = np.asarray(mean, dtype="float32")
        if mean.ndim == 1:
            mean = mean[:, None, None]      # per-channel
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def _obj_array(bufs):
    """1-D object array of per-image byte buffers — np.array(..., object)
    would go 2-D whenever the buffers happen to share a length."""
    arr = np.empty(len(bufs), dtype=object)
    arr[:] = bufs
    return arr


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pre-decode a tar of images into .npz batch files + a meta listing
    (reference batches with cPickle; npz is the numpy-native equivalent).
    Returns the meta file path."""
    out_path = f"{data_file}_{dataset_name}_batch"
    meta = os.path.join(out_path, "batch_meta")
    if os.path.exists(meta):
        return meta
    os.makedirs(out_path, exist_ok=True)
    data, labels, names, n = [], [], [], 0
    with tarfile.open(data_file) as tf:
        for member in tf.getmembers():
            if member.name not in img2label:
                continue
            data.append(np.frombuffer(tf.extractfile(member).read(),
                                      np.uint8))
            labels.append(img2label[member.name])
            if len(data) == num_per_batch:
                fname = os.path.join(out_path, f"batch_{n}.npz")
                np.savez(fname, data=_obj_array(data),
                         label=np.asarray(labels))
                names.append(fname)
                data, labels = [], []
                n += 1
        if data:
            fname = os.path.join(out_path, f"batch_{n}.npz")
            np.savez(fname, data=_obj_array(data),
                     label=np.asarray(labels))
            names.append(fname)
    with open(meta, "w") as f:
        f.write("\n".join(names))
    return meta
