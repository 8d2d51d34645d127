"""CLI: EnCodec training, reconstruction only or the full GAN recipe
(counterpart of ``audiocraft_tpu/apps/train_encodec.py``).

    python -m audiocraft_tpu_torch.apps.train_encodec --synthetic --debug --steps 2 \\
        [--adversarial] [--device cpu]

Each step trains the codec on a batch of ``--batch`` clips of ``--segment``
seconds (``dist/train.make_encodec_train_step``), or with ``--adversarial``
against the MS-STFT discriminator with the multi-scale mel loss and the
balancer (``make_encodec_gan_train_step``).  It logs ``step N  loss ...``,
or ``step N  l1 ...  msspec ...  adv ...  d_loss ...`` with
``--adversarial``.  ``--device`` defaults to the CUDA card and raises
without one; ``--device cpu`` runs on the CPU.

Launched by ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` set), every process joins one data-parallel group (NCCL on
the card, gloo on the CPU), takes its shard of each global batch and its
own card (``LOCAL_RANK``), and the step reduces over the group.

``--save-every N`` writes the whole run (the codec with its codebooks, the
optimizer moments, the discriminator and its optimizer, the balancer's
state, the weight EMA, the step and the generators) to ``--run-dir`` every N
steps and at the end (``ckpt/train_state.py``); ``--resume`` continues from
it (the synthetic batches are seeded by the step, so a resumed run trains on
the batches the whole run would have).  ``--ckpt DIR`` exports the codec at
the end as a checkpoint directory (``ckpt/io.py``; the weight EMA with
``--ema-decay``), the ``compression/`` half of what
``ckpt/loaders.get_pretrained`` serves.  The JAX package keeps the run's
state beside its model checkpoint in ``--ckpt``; here it goes to
``--run-dir``.  DATA_DIR waits for ``data/audio_dataset.py`` and raises.
``--synthetic`` (the default without DATA_DIR) trains on seeded noise.  ``--debug`` is the debug codec (and a 2-scale discriminator
of 4 filters); without it, the 32 kHz codec and the EnCodec discriminator.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('data', nargs='?', default=None)
    parser.add_argument('--steps', type=int, default=100)
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--segment', type=float, default=1.0)
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--lr-schedule', default=None,
                        choices=['cosine', 'inverse_sqrt', 'polynomial', 'linear_warmup'],
                        help='LR schedule (default: constant --lr)')
    parser.add_argument('--warmup', type=int, default=0, help='warmup steps for --lr-schedule')
    parser.add_argument('--optimizer', default='adam', choices=['adam', 'adamw'])
    parser.add_argument('--weight-decay', type=float, default=0.0)
    parser.add_argument('--max-grad-norm', type=float, default=None)
    parser.add_argument('--ema-decay', type=float, default=0.0,
                        help='>0: keep an EMA of the codec weights (saved with the run)')
    parser.add_argument('--ckpt', default=None, help='the exported model checkpoint')
    parser.add_argument('--run-dir', default=None,
                        help='directory of the saved run (--save-every, --resume)')
    parser.add_argument('--save-every', type=int, default=0,
                        help='>0: save the whole run every N steps (requires --run-dir)')
    parser.add_argument('--resume', action='store_true',
                        help='resume from the run in --run-dir')
    parser.add_argument('--debug', action='store_true', help='tiny debug codec config')
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--compute-dtype', default=None, choices=['bfloat16'],
                        help='mixed precision: bf16 SEANet forward and backward, fp32 master '
                             'weights, optimizer and quantizer')
    parser.add_argument('--adversarial', action='store_true',
                        help='the EnCodec GAN recipe: MS-STFT discriminator, hinge and '
                             'feature-matching losses, multi-scale mel, the balancer')
    parser.add_argument('--d-lr', type=float, default=3e-4,
                        help='discriminator learning rate (GAN mode)')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card); 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    if (args.save_every or args.resume) and not args.run_dir:
        parser.error('--save-every/--resume require --run-dir')
    if args.data and not args.synthetic:
        raise NotImplementedError("DATA_DIR waits for data/audio_dataset.py, which is not "
                                  "ported yet")

    import numpy as np
    import torch

    from ..adversarial import MultiScaleSTFTDiscriminator
    from ..builders import get_debug_compression_model, get_encodec_32khz, resolve_device
    from ..ckpt.io import save_checkpoint
    from ..ckpt.train_state import has_train_state, load_train_state, save_train_state
    from ..dist.mesh import in_torchrun, make_data_group, rank, shard_batch
    from ..dist.train import GAN_WEIGHTS, make_encodec_gan_train_step, make_encodec_train_step
    from ..losses import Balancer
    from ..optim import ema_update, get_lr_schedule, make_optimizer

    group = None
    device = resolve_device(args.device)
    if in_torchrun():
        if device.type == 'cuda':
            device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
            torch.cuda.set_device(device)
        group = make_data_group('nccl' if device.type == 'cuda' else 'gloo')
    model = get_debug_compression_model(32000, device=device, seed=0) if args.debug \
        else get_encodec_32khz(compute_dtype=None, device=device, seed=0)
    lr = get_lr_schedule(args.lr_schedule, args.lr, warmup_steps=args.warmup,
                         total_steps=args.steps)
    optimizer = make_optimizer(args.optimizer, lr, weight_decay=args.weight_decay,
                               max_grad_norm=args.max_grad_norm)
    params = list(model.parameters())
    opt_state = optimizer.init(params)
    wema = [p.detach().clone() for p in params] if args.ema_decay > 0 else []
    generator = torch.Generator().manual_seed(1)     # the same draws on every rank
    run = {'model': model.state_dict(), 'opt': opt_state, 'wema': wema, 'generator': generator}

    if args.adversarial:
        disc_gen = torch.Generator().manual_seed(2)
        disc = (MultiScaleSTFTDiscriminator(filters=4, n_ffts=(256, 128), hop_lengths=(64, 32),
                                            win_lengths=(256, 128), generator=disc_gen)
                if args.debug else MultiScaleSTFTDiscriminator(generator=disc_gen)).to(device)
        d_optimizer = make_optimizer(args.optimizer, args.d_lr)
        d_opt_state = d_optimizer.init(list(disc.parameters()))
        balancer = Balancer(weights=dict(GAN_WEIGHTS))
        bal_state = balancer.init_state(device)
        gan_step = make_encodec_gan_train_step(model, disc, optimizer, d_optimizer, balancer,
                                               compute_dtype=args.compute_dtype, group=group)
        run.update(disc=disc.state_dict(), d_opt=d_opt_state, bal=bal_state)

        def step_fn(x):
            return gan_step(opt_state, d_opt_state, bal_state, x, generator)
    else:
        train_step = make_encodec_train_step(model, optimizer, compute_dtype=args.compute_dtype,
                                             group=group)

        def step_fn(x):
            return train_step(opt_state, x, generator)

    seg = int(args.segment * model.sample_rate)
    start_step = 0
    if args.resume and has_train_state(args.run_dir):
        start_step, _ = load_train_state(args.run_dir, run)
        print(f"resumed at step {start_step}", flush=True)
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        # seeded by the step, so a resumed run sees the batches it would have
        rng = np.random.RandomState(step)
        wav = torch.from_numpy((rng.randn(args.batch, 1, seg) * 0.1).astype(np.float32))
        metrics = step_fn(shard_batch(wav, group).to(device))
        if wema:
            ema_update(wema, params, args.ema_decay)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            if args.adversarial:
                line = (f"l1 {m['l1']:.4f}  msspec {m['msspec']:.4f}  adv {m['adv']:.4f}  "
                        f"feat {m['feat']:.4f}  d_loss {m['d_loss']:.4f}")
            else:
                line = f"loss {m['loss']:.4f}  l1 {m['l1']:.4f}  penalty {m['penalty']:.4f}"
            if rank(group) == 0:
                print(f"step {step:5d}  {line}  ({dt:.1f}s)", flush=True)
        if args.save_every and (step + 1) % args.save_every == 0 and rank(group) == 0:
            save_train_state(args.run_dir, run, step + 1)
    if args.save_every and rank(group) == 0:
        save_train_state(args.run_dir, run, args.steps)
    if args.ckpt and rank(group) == 0:
        if wema:
            with torch.no_grad():
                for p, w in zip(params, wema):
                    p.copy_(w)
        save_checkpoint(args.ckpt, model,
                        extra={'steps': args.steps, 'weights': 'ema' if wema else 'raw'})
        print(f"saved checkpoint to {args.ckpt}")


if __name__ == '__main__':
    main()
