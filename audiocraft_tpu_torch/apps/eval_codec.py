"""CLI: codec reconstruction metrics over a corpus (counterpart of
``audiocraft_tpu/apps/eval_codec.py``, the upstream solvers' evaluate
stage for the compression model).

    python -m audiocraft_tpu_torch.apps.eval_codec DATA --ckpt CKPT_DIR \\
        [--segment 1.0] [--batch 8] [--batches 8] [--fad] [--json out.json] [--device cpu]

Prints one JSON line of per-corpus means:

* ``sisnr_db``: SI-SNR (dB, higher is better) of decode(encode(x)) against x;
* ``msspec_distance``: the multi-scale mel distance (the training loss);
* ``l1``: the waveform L1;
* ``codebook_entropy_bits`` and ``codebook_usage``: each codebook's usage
  entropy and the share of its codes used, the RVQ's health;
* ``bitrate_kbps``: frame rate x codebooks x log2(cardinality);
* with ``--fad``, codec-FAD and codec-KLD between the inputs and their
  reconstructions (``metrics.make_codec_embed_fn`` and
  ``make_codec_prob_fn``).

DATA is a directory of audio files or a jsonl manifest, read through
``data/audio_dataset.AudioDataset`` (the rank's share of each batch under
``torch.distributed``); ``--synthetic`` (or no DATA) draws numpy
``RandomState(0)`` noise.  ``--ckpt`` is a codec checkpoint directory; without
it the debug codec with random weights.  Every encode and decode runs on
the codec's default route on ``--device`` (default: the CUDA card, raising
without one; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import math


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('data', nargs='?', default=None)
    parser.add_argument('--ckpt', default=None,
                        help='codec checkpoint dir (default: the debug codec, random weights)')
    parser.add_argument('--batches', type=int, default=8)
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--segment', type=float, default=1.0)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--fad', action='store_true',
                        help='also codec-FAD and codec-KLD between the inputs and their '
                             'reconstructions (metrics.make_codec_embed_fn)')
    parser.add_argument('--json', default=None, help='also write the metrics to this file')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card); 'cpu' runs the plain "
                             "versions of the kernels")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..builders import get_debug_compression_model, resolve_device
    from ..ckpt.io import load_checkpoint
    from ..data.audio_dataset import AudioDataset
    from ..losses import MultiScaleMelSpectrogramLoss, sisnr
    from ..utils.misc import enable_compilation_cache

    device = resolve_device(args.device)
    enable_compilation_cache(device)
    if args.ckpt:
        model = load_checkpoint(args.ckpt, device)[0]
    else:
        model = get_debug_compression_model(32000, device=device, seed=0)

    seg = int(args.segment * model.sample_rate)
    if args.synthetic or args.data is None:
        rng = np.random.RandomState(0)
        batches = [(rng.randn(args.batch, 1, seg) * 0.1).astype(np.float32)
                   for _ in range(args.batches)]
    else:
        ds = AudioDataset.from_path(args.data, segment_duration=args.segment,
                                    sample_rate=model.sample_rate, channels=1,
                                    num_samples=args.batches * args.batch)
        ds.start_epoch(0)
        batches = list(ds.iter_batches(args.batch))[:args.batches]

    msspec = MultiScaleMelSpectrogramLoss(sample_rate=model.sample_rate)
    n_q, card = model.num_codebooks, model.cardinality
    counts = np.zeros((n_q, card), np.int64)
    sisnrs, mels, l1s = [], [], []
    fad = kld_rows = prob_fn = None
    if args.fad:
        from ..metrics import FrechetAudioDistance, make_codec_embed_fn, make_codec_prob_fn
        fad = FrechetAudioDistance(make_codec_embed_fn(model, window_seconds=min(args.segment,
                                                                                 1.0)),
                                   model.sample_rate)
        prob_fn = make_codec_prob_fn(model)
        kld_rows = {'ref': [], 'gen': []}
    for batch in batches:
        x = torch.from_numpy(batch).to(device)
        codes, scale = model.encode(x)
        recon = model.decode(codes, scale)[..., :x.shape[-1]]
        sisnrs.append(float(-sisnr(recon, x)))
        mels.append(float(msspec(recon, x)))
        l1s.append(float((recon - x).abs().mean()))
        c = codes.cpu().numpy()                       # [B, K, T]
        for k in range(n_q):
            counts[k] += np.bincount(c[:, k].ravel(), minlength=card)
        if args.fad:
            recon = recon.cpu().numpy()
            fad.add(reference=batch, generated=recon)
            kld_rows['ref'].append(prob_fn(batch, model.sample_rate))
            kld_rows['gen'].append(prob_fn(recon, model.sample_rate))

    probs = counts / np.maximum(counts.sum(axis=1, keepdims=True), 1)
    with np.errstate(divide='ignore', invalid='ignore'):
        ent = -np.nansum(np.where(probs > 0, probs * np.log2(probs), 0.0), axis=1)
    used = (counts > 0).mean(axis=1)
    metrics = {
        'sisnr_db': float(np.mean(sisnrs)),
        'msspec_distance': float(np.mean(mels)),
        'l1': float(np.mean(l1s)),
        'codebook_entropy_bits': [float(e) for e in ent],
        'codebook_usage': [float(u) for u in used],
        'bitrate_kbps': model.frame_rate * n_q * math.log2(card) / 1000.0,
        'n_segments': len(batches) * args.batch,
        'segment_seconds': args.segment,
    }
    if args.fad:
        from ..metrics import kl_divergence_metric
        metrics['fad_codec'] = fad.compute()
        kld = kl_divergence_metric(np.concatenate(kld_rows['ref']),
                                   np.concatenate(kld_rows['gen']))
        metrics['kld_codec'] = kld['kld']
        metrics['kld_codec_symmetric'] = kld['kld_symmetric']
    print(json.dumps(metrics))
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == '__main__':
    main()
