"""Regenerate the committed golden-run moment artifacts
(tests/golden/*.json) with LONG seeded runs. Run on CPU (the platform CI
uses) after any *intentional* change to the golden problem definitions:

    JAX_PLATFORMS=cpu python tools/make_golden.py [name ...]
"""

import sys

sys.path.insert(0, ".")

import jax

# Goldens must be generated on the platform the tests assert them on.
jax.config.update("jax_platforms", "cpu")

from mceik_tpu.diag.golden import PROBLEMS, make_golden  # noqa: E402


def main():
    names = sys.argv[1:] or list(PROBLEMS)
    for name in names:
        path, art = make_golden(name)
        ess = art["ess"]
        print(f"{name}: wrote {path}  accept={art['accept']}  "
              f"ess min/med={min(ess):.0f}/{sorted(ess)[len(ess)//2]:.0f}")


if __name__ == "__main__":
    main()
