#!/usr/bin/env python
"""Frame-to-frame registration of a video, parallel over groups of frames,
on ``dtcwt_tpu_torch``.

A video's frames are cut into GOPs (groups of frames) that overlap by one
frame, so that every neighbouring pair lies in one GOP:

* **Processes**: the GOPs are dealt round-robin over the ranks of a
  ``torch.distributed`` group (gloo: the ranks exchange nothing but their
  identity, and two ranks may share one card).  Launch one process per
  rank with the same ``--coordinator host:port`` and ``--num-processes``
  and its own ``--process-id``; without ``--coordinator`` the run has one
  rank.  Rank r computes on ``cuda:{r % torch.cuda.device_count()}``.
* **One GOP**: one ``Transform2d.forward`` of the ``[T, H, W]`` stack (the
  card's ``fwd_level1`` once and ``fwd_level2`` once a further level),
  then one ``registration.estimatereg_batched`` over the (frames[:-1],
  frames[1:]) pair views.
* **Checkpoint/resume**: each finished GOP is written to its own
  ``<output>.gopNNNN.npz`` part file, replaced atomically, and skipped on
  a restart.  ``--merge`` joins the parts into ``<output>``.

Input is an ``.npz`` stack of frames ``[T, H, W]``; a real video decoder
can be substituted in ``read_frames``.

The CUDA kernels are built at a process's first launch into
``build/kernels/``, under a name that hashes their sources; the library is
published with ``os.replace``, so ranks that build at once stay correct,
but each pays the whole ``nvcc`` build (about two minutes).  Build once
before a multi-process run: ``python -c "from dtcwt_tpu_torch.ops import
_build; _build.library()"``.

Usage:
    python examples/register_video_torch.py <input.npz> <output.npz> \\
        [--gop-size 8] [--nlevels 5] [--device cuda] [--merge]
    # two ranks, on the card or with --device cpu:
    python examples/register_video_torch.py in.npz out.npz \\
        --coordinator localhost:29500 --num-processes 2 --process-id 0 &
    python examples/register_video_torch.py in.npz out.npz \\
        --coordinator localhost:29500 --num-processes 2 --process-id 1
    python examples/register_video_torch.py in.npz out.npz --merge
"""

import argparse
import glob
import json
import logging
import os
import sys
import time

# Allow running straight from a checkout.
sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np


def read_frames(path):
    """[T, H, W] float32 frame stack from an npz (stacks per-key frames)."""
    with np.load(path) as f:
        keys = sorted(f.keys())
        arrs = [np.asarray(f[k], dtype=np.float32) for k in keys]
    if len(arrs) == 1 and arrs[0].ndim == 3:
        return arrs[0]
    return np.stack(arrs)


def register_gop(frames, nlevels, device="cuda"):
    """Affine parameter fields ``[T - 1, N, M, 6]`` (numpy) for every
    neighbouring pair of the ``[T, H, W]`` GOP *frames*, computed on
    *device*: one batched forward transform of the stack, then one
    ``estimatereg_batched`` over the pair views of its pyramid."""
    import dtcwt_tpu_torch as dt
    import dtcwt_tpu_torch.registration as reg

    pyr = dt.Transform2d(device=device).forward(frames, nlevels=nlevels)
    take = lambda sl: dt.Pyramid(pyr.lowpass[sl],
                                 tuple(h[sl] for h in pyr.highpasses))
    av = reg.estimatereg_batched(take(slice(None, -1)), take(slice(1, None)))
    return av.cpu().numpy()


def rank_device(device, rank):
    """The device rank *rank* computes on: ``cuda:{rank % cards}`` for
    ``--device cuda`` (which raises where there is no card), else
    *device*."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("--device %s: no CUDA device (pass --device cpu "
                           "for the plain PyTorch path)" % device)
    if dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def merge(args):
    parts = sorted(p for p in glob.glob(args.output + ".gop*.npz")
                   if not p.endswith(".tmp.npz"))
    pairs, avecs = [], []
    for p in parts:
        with np.load(p) as f:
            pairs.append(f["frame_idx_pairs"])
            avecs.append(f["affine_parameters"])
    np.savez_compressed(args.output,
                        frame_idx_pairs=np.concatenate(pairs),
                        affine_parameters=np.concatenate(avecs),
                        videopath=np.asarray(args.input))
    logging.info("merged %d parts, %d frame pairs",
                 len(parts), sum(len(p) for p in pairs))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--gop-size", type=int, default=8)
    ap.add_argument("--nlevels", type=int, default=5)
    ap.add_argument("--merge", action="store_true",
                    help="merge part files into <output> and exit")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the torch.distributed rendezvous; "
                         "launch one process per rank with matching "
                         "--num-processes/--process-id")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; rank r on cuda:{r %% cards}) or cpu")
    args = ap.parse_args()

    import torch.distributed as dist

    if args.coordinator is not None:
        dist.init_process_group(
            "gloo", init_method="tcp://" + args.coordinator,
            world_size=args.num_processes, rank=args.process_id)
    distributed = dist.is_initialized()
    rank = dist.get_rank() if distributed else 0
    size = dist.get_world_size() if distributed else 1
    logging.basicConfig(level=logging.INFO,
                        format="Host %d: %%(message)s" % rank)
    try:
        if args.merge:
            merge(args)
            return
        run(args, rank, size)
    finally:
        if distributed:
            dist.destroy_process_group()


def run(args, rank, size):
    from dtcwt_tpu_torch.ops import _build

    device = rank_device(args.device, rank)
    frames = read_frames(args.input)
    T = frames.shape[0]
    gop = max(args.gop_size, 2)
    # GOPs overlap by one frame so every neighbouring pair is covered.
    starts = list(range(0, T - 1, gop - 1))
    logging.info("%d frames -> %d GOPs of <=%d frames; %d host(s); "
                 "device %s", T, len(starts), gop, size, device)

    for gi, s in enumerate(starts):
        if gi % size != rank:
            continue   # another rank's GOP
        part = "%s.gop%04d.npz" % (args.output, gi)
        if os.path.exists(part):
            logging.info("GOP %d already done, skipping (resume)", gi)
            continue
        chunk = frames[s:s + gop]
        logging.info("registering GOP %d: frames [%d, %d)", gi, s,
                     s + chunk.shape[0])
        _build.reset_launches()
        t0 = time.perf_counter()
        av = register_gop(chunk, args.nlevels, device)
        secs = time.perf_counter() - t0
        idxs = np.stack([np.arange(s, s + av.shape[0]),
                         np.arange(s + 1, s + 1 + av.shape[0])], axis=1)
        tmp = part + ".tmp.npz"   # np.savez appends .npz to bare names
        np.savez_compressed(tmp, frame_idx_pairs=idxs, affine_parameters=av)
        os.replace(tmp, part)   # atomic: a crash never leaves a half GOP
        # the kernel launches of the GOP (none on the CPU's plain path)
        logging.info("GOP %d done (%d pairs) in %.3f s; kernel launches %s",
                     gi, av.shape[0], secs,
                     json.dumps(dict(sorted(_build.launches.items()))))

    logging.info("all GOPs for this host complete; run with --merge to "
                 "consolidate")


if __name__ == "__main__":
    main()
