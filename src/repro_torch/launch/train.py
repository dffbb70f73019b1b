"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port's counterpart of ``repro/launch/train.py``: the same flags and
log lines, on the port's ``Trainer``, plus three: ``--layers N`` trains a
cut depth (as the serve launcher's), ``--device`` (default the card; the
launcher raises without one unless ``--device cpu``), and ``--profile``,
which traces one more step with ``torch.profiler`` after the run and
prints its wall, the device busy time, the kernel launches and the
kernels that took the most device time (as the serve launcher's).  It
trains the dense, SSM and hybrid families.  It refuses the VLM and the
encoder-decoder (``SIDE_INPUT_REFUSAL``): the reference's launcher feeds
``SyntheticTokens``, which gives tokens only, so it trains neither family
(``loss_fn`` takes them, with the vision embeddings or the frames in the
batch: ``launch.steps.batch_specs``); the MoE family's ``loss_fn`` raises.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.serve import _profile
from repro_torch.data import SyntheticTokens
from repro_torch.runtime import Trainer, TrainerConfig


SIDE_INPUT_REFUSAL = (
    "the launcher trains on SyntheticTokens, which gives tokens only, as "
    "the reference's; the VLM's vision embeddings and the "
    "encoder-decoder's frames have no source here (train them through "
    "launch.steps.make_train_step with a batch of launch.steps.batch_specs)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="train a cut depth of N layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--profile", action="store_true",
                    help="trace one more step after the run and print the "
                         "device busy time, launches and top kernels")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, args.preset)
    if cfg.family in ("vlm", "encdec"):
        ap.error(f"{cfg.name}: {SIDE_INPUT_REFUSAL}")
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq_len,
                           global_batch=args.global_batch)
    tr = Trainer(cfg, data,
                 TrainerConfig(ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every,
                               grad_compress_bits=args.grad_compress_bits,
                               device=args.device))
    start = tr.init_or_restore()
    print(f"[train] {cfg.name}: resuming at step {start}")
    tr.run(args.steps - start)
    for m in tr.history[-5:]:
        print(f"  step {m['step']:5d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}")
    if args.profile:
        _profile(f"{cfg.name}, one train step of {args.global_batch} x "
                 f"{args.seq_len}", lambda: tr.run(1), tr.device, top=20)
    return tr


if __name__ == "__main__":
    main()
