"""Train-then-evaluate entry point (counterpart of
``celebbasis_tpu/cli/evaluate_model.py``): not ported yet.

The JAX version builds its models through ``legacy.build_legacy_ldm``, the
legacy LDM family, which the port does not have yet (ROADMAP A9).  The W4
stages it strings together are ported: ``cli/gen_imgs.py`` and
``cli/eval_imgs.py``.
"""
from __future__ import annotations


def main(argv=None):
    raise NotImplementedError(
        "cli/evaluate_model.py needs the legacy LDM family "
        "(legacy.build_legacy_ldm), which is not ported yet (ROADMAP A9); "
        "run cli/gen_imgs.py, then cli/eval_imgs.py")


if __name__ == "__main__":
    main()
