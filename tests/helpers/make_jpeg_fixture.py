"""Write the JPEG fixture under ``tests/fixtures/jpeg/``.

    python -m tests.helpers.make_jpeg_fixture [--out tests/fixtures/jpeg] [--seed 0]

Frames drawn from a seed with numpy (smooth gradients and soft-edged discs,
which compress well, not noise) and encoded with cv2 (the committed files
were written with OpenCV 5.0.0, quality 90):

- ``frame_000.jpg`` .. ``frame_004.jpg``: 1280x720 colour at 4:2:0;
- ``odd_444.jpg``: 333x251 colour at 4:4:4;
- ``grey.jpg``: 320x240 greyscale;
- ``odd_422.jpg``: 333x251 colour at 4:2:2 (odd width: the last chroma
  column covers one pixel);
- ``small_440.jpg``: 64x48 colour at 4:4:0, a sampling the card's decoder
  refuses.

Beside them, ``decoded.npz`` holds libjpeg's decode of each file (cv2's
``imread``, as RGB; the same bits as the native IO library's decode) under
the file's stem, and ``planes.npz`` libjpeg's planes before upsampling and
colour conversion (``<stem>_y``, ``_cb``, ``_cr`` at their sampled sizes;
grey has ``_y`` only) of ``frame_000``, ``odd_444``, ``grey`` and
``odd_422``, read by a
small C program built with ``g++ ... -ljpeg`` in a temporary directory
(``jpeg_read_raw_data``).  A machine without a JPEG encoder (the GPU host)
reads the files and compares its decoders with these arrays.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import subprocess
import tempfile

import numpy as np

FRAMES = tuple(f"frame_{i:03d}.jpg" for i in range(5))
ODD, GREY, ODD_422, S440 = "odd_444.jpg", "grey.jpg", "odd_422.jpg", "small_440.jpg"
QUALITY = 90

# libjpeg's raw planes of a file: a header (components, width, height, and
# each component's sampled width and height), then each plane's rows
RAW_PLANES_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb"); FILE* o = fopen(argv[2], "wb");
  struct jpeg_decompress_struct c; struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e); jpeg_create_decompress(&c); jpeg_stdio_src(&c, f);
  jpeg_read_header(&c, TRUE); c.raw_data_out = TRUE; jpeg_start_decompress(&c);
  int nc = c.num_components, maxv = c.max_v_samp_factor, row = 0;
  int hdr[3 + 2 * 4] = {nc, (int)c.output_width, (int)c.output_height};
  unsigned char* planes[4]; int pw[4];
  for (int k = 0; k < nc; k++) {
    jpeg_component_info* ci = &c.comp_info[k];
    hdr[3 + 2 * k] = ci->downsampled_width; hdr[4 + 2 * k] = ci->downsampled_height;
    pw[k] = ci->width_in_blocks * 8;
    planes[k] = calloc((size_t)pw[k] * (ci->height_in_blocks + ci->v_samp_factor) * 8, 1);
  }
  fwrite(hdr, sizeof(int), 3 + 2 * nc, o);
  while (c.output_scanline < c.output_height) {
    JSAMPROW rows[4][64]; JSAMPARRAY arr[4];
    for (int k = 0; k < nc; k++) {
      int n = c.comp_info[k].v_samp_factor * 8, base = row / maxv * c.comp_info[k].v_samp_factor;
      for (int r = 0; r < n; r++) rows[k][r] = planes[k] + (size_t)(base + r) * pw[k];
      arr[k] = rows[k];
    }
    row += jpeg_read_raw_data(&c, arr, maxv * 8);
  }
  for (int k = 0; k < nc; k++)
    for (int r = 0; r < hdr[4 + 2 * k]; r++)
      fwrite(planes[k] + (size_t)r * pw[k], 1, hdr[3 + 2 * k], o);
  jpeg_finish_decompress(&c); fclose(o); return 0;
}
"""


def raw_planes(paths) -> dict:
    """libjpeg's planes of each file, by ``<stem>_y`` / ``_cb`` / ``_cr``."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = osp.join(tmp, "raw.c"), osp.join(tmp, "raw")
        with open(src, "w") as fh:
            fh.write(RAW_PLANES_C)
        subprocess.run(["g++", "-O2", "-xc", src, "-o", exe, "-ljpeg"], check=True)
        for path in paths:
            dump = osp.join(tmp, "planes.bin")
            subprocess.run([exe, path, dump], check=True)
            blob = open(dump, "rb").read()
            nc = int(np.frombuffer(blob[:4], np.int32)[0])
            hdr = np.frombuffer(blob[:4 * (3 + 2 * nc)], np.int32)
            offset = 4 * len(hdr)
            stem = osp.splitext(osp.basename(path))[0]
            for k, name in zip(range(nc), ("y", "cb", "cr")):
                w, h = int(hdr[3 + 2 * k]), int(hdr[4 + 2 * k])
                out[f"{stem}_{name}"] = np.frombuffer(blob[offset:offset + w * h],
                                                      np.uint8).reshape(h, w)
                offset += w * h
    return out


def draw(rng: np.random.RandomState, h: int, w: int, discs: int = 6) -> np.ndarray:
    """(h, w, 3) uint8: a linear colour gradient with ``discs`` soft discs."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    c0, cx, cy = rng.uniform(0, 255, 3), rng.uniform(-120, 120, 3), rng.uniform(-120, 120, 3)
    img = c0 + cx * (xx / w)[..., None] + cy * (yy / h)[..., None]
    for _ in range(discs):
        px, py = rng.uniform(0, w), rng.uniform(0, h)
        r = rng.uniform(0.04, 0.15) * min(h, w)
        colour = rng.uniform(0, 255, 3)
        alpha = np.clip((r - np.hypot(xx - px, yy - py)) / 3.0, 0.0, 1.0)[..., None]
        img = img * (1 - alpha) + colour * alpha
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def main(argv=None) -> None:
    import cv2

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                                              "fixtures", "jpeg"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    s420 = [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    s444 = [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    for name in FRAMES:
        rgb = draw(rng, 720, 1280)
        cv2.imwrite(osp.join(args.out, name), rgb[..., ::-1], s420)
    cv2.imwrite(osp.join(args.out, ODD), draw(rng, 251, 333, discs=3)[..., ::-1], s444)
    cv2.imwrite(osp.join(args.out, GREY), draw(rng, 240, 320, discs=3)[..., 0],
                [cv2.IMWRITE_JPEG_QUALITY, QUALITY])
    for name, (h, w), factor in ((ODD_422, (251, 333), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
                                 (S440, (48, 64), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)):
        cv2.imwrite(osp.join(args.out, name), draw(rng, h, w, discs=3)[..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
    decoded = {}
    for name in FRAMES + (ODD, GREY, ODD_422, S440):
        im = cv2.imread(osp.join(args.out, name), cv2.IMREAD_COLOR)
        decoded[osp.splitext(name)[0]] = np.ascontiguousarray(im[..., ::-1])
    np.savez_compressed(osp.join(args.out, "decoded.npz"), **decoded)
    np.savez_compressed(osp.join(args.out, "planes.npz"), **raw_planes(
        [osp.join(args.out, n) for n in (FRAMES[0], ODD, GREY, ODD_422)]))
    total = sum(osp.getsize(osp.join(args.out, f)) for f in os.listdir(args.out))
    print(f"wrote {len(decoded)} jpgs, decoded.npz and planes.npz to {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
