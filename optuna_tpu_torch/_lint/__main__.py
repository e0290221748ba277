"""``python -m optuna_tpu_torch._lint`` — see cli.py for flags."""

from optuna_tpu_torch._lint.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
