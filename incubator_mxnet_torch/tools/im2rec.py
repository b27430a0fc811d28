"""Pack an image folder (or a .lst file) into a RecordIO shard (the
port's copy of the JAX package's `tools/im2rec.py`).

List mode writes ``prefix.lst`` (index, label, relative path, one line
each, tab-separated); pack mode writes ``prefix.rec`` and ``prefix.idx``,
readable by `ImageRecordIter`, `ImageIter` and `ImageRecordDataset` of
either package.  Images are read and re-encoded through the port's own
codecs, so no PIL is needed.

    python -m incubator_mxnet_torch.tools.im2rec PREFIX ROOT [--list]
        [--resize N] [--quality Q] [--no-shuffle] [--pass-through]
"""
import argparse
import os
import random

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def make_list(args):
    entries = []
    classes = sorted(
        d for d in os.listdir(args.root)
        if os.path.isdir(os.path.join(args.root, d)))
    if classes:
        for label, cls in enumerate(classes):
            for fn in sorted(os.listdir(os.path.join(args.root, cls))):
                if fn.lower().endswith(_EXTS):
                    entries.append((label, os.path.join(cls, fn)))
    else:
        for fn in sorted(os.listdir(args.root)):
            if fn.lower().endswith(_EXTS):
                entries.append((0, fn))
    if args.shuffle:
        random.Random(42).shuffle(entries)
    with open(args.prefix + ".lst", "w") as f:
        for i, (label, path) in enumerate(entries):
            f.write(f"{i}\t{label}\t{path}\n")
    print(f"wrote {len(entries)} entries to {args.prefix}.lst")
    return entries


def pack(args):
    from ..image import imdecode, resize_short
    from ..recordio import IRHeader, MXIndexedRecordIO, pack_img
    from ..recordio import pack as rec_pack

    lst = args.prefix + ".lst"
    if not os.path.exists(lst):
        make_list(args)
    rec = MXIndexedRecordIO(args.prefix + ".idx", args.prefix + ".rec", "w")
    n = 0
    with open(lst) as f:
        for line in f:
            idx, label, rel = line.strip().split("\t")
            with open(os.path.join(args.root, rel), "rb") as imf:
                buf = imf.read()
            header = IRHeader(0, float(label), int(idx), 0)
            if args.resize or args.pass_through is False:
                img = imdecode(buf)
                if args.resize:
                    img = resize_short(img, args.resize)
                rec.write_idx(int(idx), pack_img(header, img,
                                                 quality=args.quality))
            else:
                rec.write_idx(int(idx), rec_pack(header, buf))
            n += 1
    rec.close()
    print(f"packed {n} images into {args.prefix}.rec (+ .idx)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("prefix", help="output prefix (prefix.rec/.idx/.lst)")
    ap.add_argument("root", help="image root directory")
    ap.add_argument("--list", action="store_true",
                    help="only generate the .lst file")
    ap.add_argument("--resize", type=int, default=0,
                    help="resize shorter edge before packing")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--shuffle", action="store_true", default=True)
    ap.add_argument("--no-shuffle", dest="shuffle", action="store_false")
    ap.add_argument("--pass-through", action="store_true", default=False,
                    help="pack raw file bytes without re-encoding")
    args = ap.parse_args(argv)
    if args.list:
        make_list(args)
    else:
        pack(args)


if __name__ == "__main__":
    main()
