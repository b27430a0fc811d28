"""Image-record shards for input benchmarks, and the pipeline's feed rate
(the port's copy of `build_shard` in the JAX package's
`tools/io_bench.py`).

`build_shard` writes the same images from the same seed as the JAX
package's (8 x 8 blocks of random color plus N(0, 12^2) noise, whose JPEG
entropy is close to a photo's), encoded by the port's JPEG encoder, so a
machine without PIL builds `bench_resnet50_input`'s shard.

    python -m incubator_mxnet_torch.tools.io_bench [--images 1024]
        [--size 256] [--quality 85] [--crop 224] [--batch 256]
        [--threads N]
"""
import argparse
import json
import os
import tempfile
import time


def block_image(rng, h, w):
    """An h x w x 3 uint8 image: 8 x 8 blocks of random color plus
    N(0, 12^2) noise, drawn from numpy RandomState `rng`.  Low-frequency
    structure and noise give a JPEG entropy close to a photo's (noise
    alone decodes unrealistically slowly, flat images too fast)."""
    import numpy as np
    base = rng.randint(0, 255, (8, 8, 3)).astype(np.float32)
    big = np.kron(base, np.ones((-(-h // 8), -(-w // 8), 1), np.float32))
    return np.clip(big[:h, :w] + rng.randn(h, w, 3) * 12, 0,
                   255).astype(np.uint8)


def build_shard(path, n_images, size, quality, seed=0):
    """Write `n_images` size x size JPEGs at `quality` to the RecordIO
    file `path` (labels i % 1000); returns the seconds it took."""
    import numpy as np
    from ..recordio import IRHeader, MXRecordIO, pack_img
    rng = np.random.RandomState(seed)
    rec = MXRecordIO(path, "w")
    t0 = time.time()
    for i in range(n_images):
        rec.write(pack_img(IRHeader(0, float(i % 1000), i, 0),
                           block_image(rng, size, size), quality=quality))
    rec.close()
    return time.time() - t0


def feed_rate(path, crop, batch, threads, epochs=2, **kwargs):
    """Images/s of the native pipeline draining whole epochs (NHWC
    uint8, random crop and mirror, resize_short crop + crop // 8)."""
    from ..io.native_image import NativeImagePipeline
    pipe = NativeImagePipeline(
        path, (3, crop, crop), batch, preprocess_threads=threads,
        prefetch=4, shuffle=True, resize=crop + crop // 8, rand_crop=True,
        rand_mirror=True, out_uint8=True, **kwargs)
    try:
        while pipe.next_arrays() is not None:      # warm the page cache
            pass
        rates = []
        for _ in range(epochs):
            pipe.reset()
            t0 = time.perf_counter()
            k = 0
            while pipe.next_arrays() is not None:
                k += 1
            rates.append(k * batch / (time.perf_counter() - t0))
        return {"images_per_s": rates, "decode_failures":
                pipe.decode_failures}
    finally:
        pipe.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", type=int, default=1024)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--quality", type=int, default=85)
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        rec = os.path.join(d, "shard.rec")
        secs = build_shard(rec, args.images, args.size, args.quality)
        out = feed_rate(rec, args.crop, args.batch, args.threads)
        out.update(build_s=secs, host_cores=os.cpu_count(),
                   **{k: getattr(args, k) for k in
                      ("images", "size", "quality", "crop", "batch",
                       "threads")})
        print(json.dumps(out))


if __name__ == "__main__":
    main()
