"""`bic` — unified CLI subsuming the reference's driver zoo.

Replaces: compress_test..compress8_test (estimate), bsvd_test (bsvd),
bitplane_tool / plane2pgm_tool (bitplanes / planes2pgm) — and adds what the
reference never had: real compress/decompress with bit-exact round-trip.

    python -m binary_image_compression_tpu compress  in.pbm out.bic [opts]
    python -m binary_image_compression_tpu decompress in.bic out.pbm
    python -m binary_image_compression_tpu estimate  in.pbm --driver 8 [opts]
    python -m binary_image_compression_tpu bsvd      in.pbm [bsvd_test flags]
    python -m binary_image_compression_tpu bitplanes in.pgm [--prefix plane_]
    python -m binary_image_compression_tpu planes2pgm prefix out.pgm
    python -m binary_image_compression_tpu info      in.bic
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys

import numpy as np


def _add_codec_opts(p):
    p.add_argument("--codec", default="8",
                   help="1 full-prior-area, 2/3 dict, 4/6/7/8 windowed, "
                        "10 med+rle, 11 bsvd, "
                        "12 cabic/arithmetic, 13 scab striped-arithmetic — "
                        "best ratio, parallel decode, device context stage "
                        "(default 8)")
    p.add_argument("-W", type=int, default=16, help="tile width")
    p.add_argument("-T", type=int, default=None, help="early-exit threshold")
    p.add_argument("-R", type=int, default=128, help="search radius")
    p.add_argument("--mode", choices=["strict", "causal"], default="causal",
                   help="strict = reference residual-substitution; causal = "
                        "original-pixel refs (parallel, usually smaller)")
    p.add_argument("--backend", choices=["auto", "host", "tpu"],
                   default="auto")
    p.add_argument("--entropy", choices=["host", "device"], default="host",
                   help="codec 13 only: host = adaptive range coder "
                        "(best ratio on small pages), device = static-table "
                        "interleaved rANS assembled entirely on device "
                        "(payload mode 2; wins on doc-class pages)")
    p.add_argument("--shard", choices=["none", "tiles"], default="none",
                   help="tiles: shard ONE image's tile grid over all "
                        "devices (multi-hop ppermute halo; byte-identical "
                        "streams) — BASELINE config #4")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage wall clock + MB/s")


def cmd_compress(args):
    from .models import codec, compress
    from .utils import pnm
    if args.codec == "auto":
        return _compress_auto(args)
    # honor the user's codec flags for gray/color input; a bare
    # `bic compress in.pgm out.bic` keeps per-plane auto-selection
    # (checked against the raw string BEFORE the int conversion)
    explicit = (args.codec != "8" or args.W != 16 or args.T is not None
                or args.R != 128 or args.mode != "causal")
    args.codec = int(args.codec)
    params = codec.CodecParams(codec=args.codec, W=args.W, T=args.T,
                               R=args.R, strict=args.mode == "strict")
    backend = "tpu" if args.backend == "tpu" else "host"
    if getattr(args, "entropy", "host") == "device":
        backend = "tpu-rans"     # PGM/PPM: whole-stack device entropy
    ext = os.path.splitext(args.input)[1].lower()
    if ext == ".ppm":
        rgb, maxval = pnm.read_pnm(args.input)
        blob = codec.encode_ppm(rgb, maxval, params if explicit else None,
                                backend=backend)
        raw = rgb.size * 3
    elif ext in (".pgm", ".pnm"):
        gray, maxval = pnm.read_pnm(args.input)
        blob = codec.encode_pgm(gray, maxval,
                                params if explicit else None,
                                backend=backend)
        raw = gray.size * (2 if maxval > 255 else 1)
    else:
        img = pnm.read_pbm(args.input)
        if getattr(args, "shard", "none") == "tiles":
            if not (args.codec in (4, 7, 8) and args.mode == "causal"):
                sys.exit("--shard tiles requires a windowed codec (4/7/8) "
                         "in causal mode")
            from .parallel import mesh as pmesh
            from .parallel import tileshard
            import jax
            m = pmesh.make_mesh(len(jax.devices()), data=len(jax.devices()),
                                model=1)
            blob = tileshard.encode_tile_sharded(m, img, params)
        elif args.codec == 8 and args.mode == "causal" \
                and args.backend in ("auto", "tpu"):
            prof = None
            if getattr(args, "profile", False):
                from .utils.profiling import PipelineProfile
                prof = PipelineProfile()
            blob = compress.encode(img, params, profile=prof)
            if prof is not None:
                print(prof.report())
        elif args.codec == 13 and getattr(args, "entropy",
                                          "host") == "device":
            # the WHOLE payload assembles on device (mode-2 rANS)
            blob = compress.encode_scab(img, params, entropy="device")
        elif args.codec == 13 and args.backend == "tpu":
            # context template on device, range-coder update on host
            blob = compress.encode_scab(img, params)
        else:
            blob = codec.encode(img, params)
        raw = img.size // 8
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"{args.input}: {raw}B raw -> {len(blob)}B "
          f"({100.0 * len(blob) / raw:.2f}%)")


def _compress_auto(args):
    """--codec auto: race the windowed and arithmetic codecs, keep smaller."""
    from .models import codec
    from .utils import pnm
    img = pnm.read_pbm(args.input)
    cands = [codec.CodecParams(codec=13, W=0, T=0, R=0),
             codec.CodecParams(codec=8, W=args.W, R=args.R,
                               strict=args.mode == "strict")]
    best = min((codec.encode(img, p) for p in cands), key=len)
    with open(args.output, "wb") as f:
        f.write(best)
    raw = img.size // 8
    print(f"{args.input}: {raw}B raw -> {len(best)}B "
          f"({100.0 * len(best) / raw:.2f}%, codec {best[8]})")


def cmd_decompress(args):
    from .models import codec
    from .utils import pnm
    blob = open(args.input, "rb").read()
    if blob[:4] == codec.PPM_MAGIC:
        rgb, maxval = codec.decode_ppm(blob)
        pnm.write_ppm(rgb, maxval, args.output)
    elif blob[:4] == codec.PGM_MAGIC:
        gray, maxval = codec.decode_pgm(blob)
        pnm.write_pgm(gray, maxval, args.output)
    else:
        img = codec.decode(blob)
        pnm.write_pbm(img, args.output)
    print(f"wrote {args.output}")


def cmd_estimate(args):
    """Reference-parity codelength estimate (the compressN_test outputs)."""
    from .models import ref_parity as rp
    from .utils import pnm
    img = pnm.read_pbm(args.input)
    fns = {1: rp.compress1, 2: rp.compress2, 3: rp.compress3,
           4: rp.compress4, 5: rp.compress5, 6: rp.compress6,
           7: rp.compress7, 8: rp.compress8}
    kw = {}
    if args.driver >= 3 and args.T is not None:
        kw["T"] = args.T
    if args.driver >= 4:
        kw["R"] = args.R
    if args.driver == 8 and args.T is not None:
        kw["T"] = args.T
    out = fns[args.driver](img, W=args.W, **kw)
    skip = ("map", "hist_weight", "hist_besti", "hist_bestj", "hist_radius")
    final = {k: v for k, v in out["final"].items() if k not in skip}
    print(json.dumps(final, indent=1, default=str))
    if "map" in out["final"]:
        print("MAP:")
        for line in out["final"]["map"]:
            print(line)

    def print_hist(hist, logscale):
        # the reference's ASCII histograms (compress4_test.cpp:41-50)
        import math
        for i, h in enumerate(hist):
            top = int(math.ceil(math.log2(h + 1.0))) if logscale else h
            print(f"{i}:" + "#" * top)

    f = out["final"]
    if "hist_weight" in f:
        for name, log in (("hist_weight", True), ("hist_besti", False),
                          ("hist_bestj", False), ("hist_radius", False)):
            print(f"{name.upper()}:")
            print_hist(f[name], log)


def cmd_bsvd(args):
    from .models import bsvd_ref, bsvd
    from .utils import pnm, mosaic
    from .ops import bitpack
    img = pnm.read_pbm(args.input)
    if args.backend == "tpu":
        X = bsvd.patchify_to_rows(img, args.w) if args.I else \
            np.asarray(img, dtype=np.int8)
        # reference mi catalog order (bsvd.cpp:25-31); 3 (xor centroids) has
        # no device twin and falls back to the majority-vote centroids
        init = {0: "neighbor", 1: "partition", 2: "random_centroids",
                3: "random_centroids", 4: "graph_grow"}.get(args.i,
                                                            "neighbor")
        du = "proximus" if args.d in (1, 3) else "steepest"
        if args.l == 4:  # MDL forward selection (bsvd.cpp:1463-1546)
            E, D, A, bestL = bsvd.learn_mdl_forward(
                X, K0=max(1, args.k // 8), max_k=args.k, init=init,
                dict_update=du, seed=args.r)
        elif args.l in (1, 2, 3):  # role-switching loops
            E, D, A, iters = bsvd.learn_alter(X, K=args.k, init=init,
                                              variant=args.l,
                                              dict_update=du, seed=args.r)
        elif args.l == 5:  # MDL backward selection (bsvd.cpp:1548-1663)
            E, D, A, bestL = bsvd.learn_mdl_backward(
                X, K0=args.k, init=init, dict_update=du, seed=args.r)
        elif args.l >= 6:  # MDL full search (bsvd.cpp:1665-1717)
            E, D, A, bestL = bsvd.learn_mdl_full(
                X, Kmax=args.k, Kstep=max(1, args.k // 2), init=init,
                dict_update=du, seed=args.r)
        else:
            E, D, A, iters = bsvd.learn(X, K=args.k, init=init,
                                        dict_update=du, seed=args.r)
        D, A, E = (np.asarray(D, bool), np.asarray(A, bool),
                   np.asarray(E, bool))
        wE = int(E.sum())
    elif args.l >= 4:  # reference MDL selection loops (parity layer)
        direction = "forward" if args.l == 4 else "backward"
        out = bsvd_ref.run_mdl(
            img, W=args.w, K0=max(1, args.k // 8), image_mode=bool(args.I),
            mi=args.i, cu=args.c, du=args.d, lmi=args.L,
            direction=direction, seed=args.r)
        D, A, E = out["D"], out["A"], out["E"]
        wE = int(E.sum())
    else:
        D, A, E, wE, res = bsvd_ref.run_bsvd_test(
            img, W=args.w, K=args.k, image_mode=bool(args.I), mi=args.i,
            cu=args.c, du=args.d, lm=args.l, seed=args.r)
    out = args.out_dir
    pnm.write_pbm(D, os.path.join(out, "dictionary.pbm"))
    pnm.write_pbm(A, os.path.join(out, "coefficients.pbm"))
    pnm.write_pbm(E, os.path.join(out, "residual.pbm"))
    if args.m:
        mos = mosaic.render_mosaic(bitpack.np_pack(D), D.shape[1])
        pnm.write_pbm(mos, os.path.join(out, "atoms_mosaic.pbm"))
    if args.M:
        mos = mosaic.render_mosaic(bitpack.np_pack(E), E.shape[1])
        pnm.write_pbm(mos, os.path.join(out, "residual_mosaic.pbm"))
    print(f"|E| = {wE}  (K={D.shape[0]}, M={D.shape[1]}, N={A.shape[0]})")


def cmd_bitplanes(args):
    from .utils import pnm, bitplanes
    gray, maxval = pnm.read_pnm(args.input)
    planes = bitplanes.decompose(gray, maxval)
    for i in range(planes.shape[0]):
        pnm.write_pbm(planes[i], f"{args.prefix}{i:02d}.pbm")
    print(f"wrote {planes.shape[0]} planes ({args.prefix}NN.pbm)")


def cmd_planes2pgm(args):
    from .utils import pnm, bitplanes
    planes = []
    i = 0
    while os.path.exists(f"{args.prefix}{i:02d}.pbm"):
        planes.append(pnm.read_pbm(f"{args.prefix}{i:02d}.pbm"))
        i += 1
    if not planes:
        sys.exit(f"no {args.prefix}NN.pbm files found")
    gray = bitplanes.recompose(np.stack(planes))
    # reference writes maxval = final mask (plane2pgm_tool.cpp:53)
    pnm.write_pgm(gray, (1 << len(planes)) - 1, args.output)
    print(f"wrote {args.output} from {len(planes)} planes")


def cmd_compare(args):
    from .models import codec
    from .utils import pnm
    img = pnm.read_pbm(args.input)
    raw = img.size // 8
    rows = [("raw", raw, None)]
    for cid, label in [(2, "dict"), (3, "dict+T"), (4, "window"),
                       (7, "window+pred"), (8, "window+pred+inv"),
                       (10, "med+rle"), (12, "cabic/arithmetic"),
                       (13, "scab/striped-arith")]:
        p = codec.CodecParams(codec=cid, W=args.W if cid < 10 else 0,
                              R=args.R, T=0 if cid >= 12 else None,
                              strict=False)
        try:
            blob = codec.encode(img, p)
            ok = bool((codec.decode(blob) == img).all())
            rows.append((f"codec {cid} ({label})", len(blob), ok))
        except Exception as e:  # pragma: no cover
            rows.append((f"codec {cid} ({label})", None, str(e)[:40]))
    w = max(len(r[0]) for r in rows)
    for name, size, ok in rows:
        pct = f"{100.0 * size / raw:6.1f}%" if size else "   n/a"
        tail = "" if ok in (None, True) else f"  [{ok}]"
        print(f"{name:<{w}}  {size or 0:>8}B  {pct}{tail}")


def cmd_archive(args):
    from .models import archive, codec
    from .utils import pnm
    params = codec.CodecParams(codec=args.codec, W=args.W, T=args.T,
                               R=args.R, strict=args.mode == "strict")
    pages = [pnm.read_pbm(f) for f in args.inputs]
    blob = archive.encode_archive(pages, params,
                                  use_tpu=args.backend != "host")
    with open(args.output, "wb") as f:
        f.write(blob)
    raw = sum(p.size // 8 for p in pages)
    print(f"{len(pages)} pages: {raw}B raw -> {len(blob)}B "
          f"({100.0 * len(blob) / raw:.2f}%)")


def cmd_extract(args):
    from .models import archive
    from .utils import pnm
    blob = open(args.input, "rb").read()
    try:
        page = archive.decode_page(blob, args.page)
    except IndexError:
        sys.exit(f"error: page {args.page} out of range "
                 f"(archive has {archive.page_count(blob)} pages)")
    pnm.write_pbm(page, args.output)
    print(f"wrote page {args.page} -> {args.output}")


def cmd_info(args):
    from .models import codec, archive
    blob = open(args.input, "rb").read()
    if blob[:4] == archive.MAGIC:
        n = archive.page_count(blob)
        print(json.dumps({"container": "BICA", "pages": n,
                          "bytes": len(blob)}))
        return
    if blob[:4] == codec.PGM_MAGIC:
        nplanes, gflag, maxval = struct.unpack("<BBH", blob[4:8])
        print(json.dumps({"container": "BICG", "planes": nplanes,
                          "gray_code": bool(gflag), "maxval": maxval,
                          "bytes": len(blob)}))
        return
    if blob[:4] != codec.MAGIC:
        sys.exit("not a BIC stream")
    crc, cid, flags, W, rows, cols, T, R = struct.unpack(
        "<IBBHIIII", blob[4:28])
    print(json.dumps({"container": "BIC1", "codec": cid,
                      "mode": "strict" if flags & 1 else "causal",
                      "W": W, "rows": rows, "cols": cols, "T": T, "R": R,
                      "bytes": len(blob),
                      "raw_bytes": rows * cols // 8}))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bic", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compress", help="PBM/PGM -> .bic")
    p.add_argument("input")
    p.add_argument("output")
    _add_codec_opts(p)
    p.set_defaults(fn=cmd_compress)

    p = sub.add_parser("decompress", help=".bic -> PBM/PGM")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=cmd_decompress)

    p = sub.add_parser("estimate",
                       help="reference-parity codelength report")
    p.add_argument("input")
    p.add_argument("--driver", type=int, default=8, choices=range(1, 9))
    p.add_argument("-W", type=int, default=16)
    p.add_argument("-T", type=int, default=None)
    p.add_argument("-R", type=int, default=128)
    p.set_defaults(fn=cmd_estimate)

    p = sub.add_parser("bsvd", help="binary dictionary learning "
                                    "(bsvd_test flags)")
    p.add_argument("input")
    p.add_argument("-i", type=int, default=0, help="initializer 0-4")
    p.add_argument("-c", type=int, default=0, help="coef update 0-1")
    p.add_argument("-d", type=int, default=0, help="dict update 0-3")
    p.add_argument("-l", type=int, default=0, help="learning loop 0-3")
    p.add_argument("-L", type=int, default=0, help="inner loop (MDL)")
    p.add_argument("-w", type=int, default=16, help="patch width")
    p.add_argument("-k", type=int, default=512, help="dictionary size")
    p.add_argument("-r", type=int, default=34503498, help="random seed")
    p.add_argument("-I", type=int, default=0, help="image mode (patchify)")
    p.add_argument("-m", type=int, default=1, help="write atoms mosaic")
    p.add_argument("-M", type=int, default=1, help="write residual mosaic")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--backend", choices=["ref", "tpu"], default="ref")
    p.set_defaults(fn=cmd_bsvd)

    p = sub.add_parser("bitplanes", help="PGM -> plane_NN.pbm")
    p.add_argument("input")
    p.add_argument("--prefix", default="plane_")
    p.set_defaults(fn=cmd_bitplanes)

    p = sub.add_parser("planes2pgm", help="plane_NN.pbm -> PGM")
    p.add_argument("prefix")
    p.add_argument("output")
    p.set_defaults(fn=cmd_planes2pgm)

    p = sub.add_parser("compare", help="size comparison across codecs")
    p.add_argument("input")
    p.add_argument("-W", type=int, default=16)
    p.add_argument("-R", type=int, default=128)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("archive", help="many PBMs -> one .bica corpus")
    p.add_argument("inputs", nargs="+")
    p.add_argument("output")
    _add_codec_opts(p)
    p.set_defaults(fn=cmd_archive)

    p = sub.add_parser("extract", help="page from a .bica corpus")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--page", type=int, default=0)
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("info", help="inspect a .bic container")
    p.add_argument("input")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    from .utils import compile_cache
    compile_cache.enable()
    args.fn(args)


if __name__ == "__main__":
    main()
