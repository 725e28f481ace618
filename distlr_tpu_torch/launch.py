"""Command-line entry point of the port: ``gen-data``, ``sync`` and ``eval``.

Counterpart of ``distlr_tpu/launch.py`` for the options the port carries,
with the same flag names, plus ``--device`` (default ``cuda``; the CPU
only when asked for).  Run as ``python -m distlr_tpu_torch.launch``::

    python -m distlr_tpu_torch.launch gen-data --data-dir D --num-feature-dim 123 \\
        --num-samples 2000 --num-parts 2
    python -m distlr_tpu_torch.launch sync --data-dir D --num-feature-dim 123 --num-workers 2
    python -m distlr_tpu_torch.launch eval --data-dir D --num-feature-dim 123 \\
        --model-file D/models/part-001
"""

from __future__ import annotations

import argparse
import sys

from distlr_tpu_torch.config import Config
from distlr_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_CONFIG_FIELDS = (
    "data_dir", "num_feature_dim", "num_iteration", "batch_size",
    "learning_rate", "l2_c", "test_interval", "model", "compat_mode",
    "random_seed", "prefetch", "feature_dtype", "num_workers", "device",
)


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-dir", dest="data_dir")
    p.add_argument("--num-feature-dim", dest="num_feature_dim", type=int)
    p.add_argument("--num-iteration", dest="num_iteration", type=int)
    p.add_argument("--batch-size", dest="batch_size", type=int)
    p.add_argument("--learning-rate", dest="learning_rate", type=float)
    p.add_argument("--l2-c", dest="l2_c", type=float)
    p.add_argument("--test-interval", dest="test_interval", type=int)
    p.add_argument("--model", choices=["binary_lr", "softmax", "sparse_lr",
                                       "sparse_softmax", "blocked_lr"],
                   help="binary_lr is ported; the others name their ROADMAP item")
    p.add_argument("--compat-mode", dest="compat_mode", choices=["correct", "reference"])
    p.add_argument("--random-seed", dest="random_seed", type=int,
                   help="seed of the uniform weight init (default 10)")
    p.add_argument("--prefetch", dest="prefetch", type=int,
                   help="host->device streaming depth in Trainer.fit "
                   "(default 2 = double buffering; 1 = strictly serial)")
    p.add_argument("--feature-dtype", dest="feature_dtype",
                   choices=["float32", "bfloat16", "int8", "int8_dot"],
                   help="device-resident storage dtype for dense features "
                   "(bfloat16 halves the bytes the step reads; int8 and "
                   "int8_dot are not ported yet)")
    p.add_argument("--num-workers", dest="num_workers", type=int,
                   help="data-parallel shards, as row blocks of one batch")
    p.add_argument("--device", dest="device",
                   help="cuda (default), cuda:N or cpu")


def _config_from_args(args: argparse.Namespace) -> Config:
    return Config(**{k: v for k, v in vars(args).items()
                     if v is not None and k in _CONFIG_FIELDS})


def cmd_gen_data(args: argparse.Namespace) -> int:
    from distlr_tpu_torch.data.synthetic import write_synthetic_shards  # noqa: PLC0415

    manifest = write_synthetic_shards(
        args.data_dir,
        args.num_samples,
        args.num_feature_dim,
        args.num_parts,
        seed=args.seed,
        num_classes=args.num_classes,
        sparsity=args.sparsity,
    )
    log.info("wrote %d train shards + test to %s", len(manifest["train_parts"]), args.data_dir)
    return 0


def cmd_sync(args: argparse.Namespace) -> int:
    from distlr_tpu_torch.train import Trainer  # noqa: PLC0415

    trainer = Trainer(_config_from_args(args)).load_data()
    trainer.fit()
    path = trainer.save_model()
    log.info(
        "final accuracy %.4f, %.0f samples/sec, model -> %s",
        trainer.evaluate(), trainer.timer.samples_per_sec, path,
    )
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    """Score a saved text model against a data dir's test split."""
    from distlr_tpu_torch.convert import params_from_jax  # noqa: PLC0415
    from distlr_tpu_torch.train import Trainer  # noqa: PLC0415
    from distlr_tpu_torch.train.export import load_model_text  # noqa: PLC0415

    cfg = _config_from_args(args)
    trainer = Trainer(cfg).load_data(test_only=cfg.feature_dtype == "float32")
    w = load_model_text(args.model_file, shape=trainer.model.param_shape)
    trainer.weights = params_from_jax(w, trainer.model, trainer.device)
    m = trainer.evaluate_metrics()
    print(f"accuracy: {m['accuracy']:.4f}  test_logloss: {m['logloss']:.5f}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="distlr_tpu_torch.launch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen-data", help="write seeded synthetic libsvm shards")
    g.add_argument("--data-dir", required=True)
    g.add_argument("--num-samples", type=int, default=10000)
    g.add_argument("--num-feature-dim", type=int, default=123)
    g.add_argument("--num-parts", type=int, default=4)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--num-classes", type=int, default=2)
    g.add_argument("--sparsity", type=float, default=0.5)
    g.set_defaults(fn=cmd_gen_data)

    s = sub.add_parser("sync", help="synchronous data-parallel training (one card)")
    _add_config_flags(s)
    s.set_defaults(fn=cmd_sync)

    e = sub.add_parser("eval", help="score a saved text model on the test split")
    _add_config_flags(e)
    e.add_argument("--model-file", dest="model_file", required=True,
                   help="text model file (the reference SaveModel format; "
                        "what sync runs write to models/part-001)")
    e.set_defaults(fn=cmd_eval)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
