"""CLI entry point: ``python -m goma_tpu deck.json``.

Parity: the reference binary's invocation ``goma -a -i input.in``
(``src/main.c:262 main``): read a deck, solve (steady Newton or transient
when a "time" section is present), write Exodus output, exit nonzero on
non-convergence. JSON decks go through the sandboxed ``expr:`` expansion
(the aprepro analog); see docs/DECK_REFERENCE.md for the schema.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m goma_tpu",
        description="Solve a declarative goma_tpu deck (JSON).")
    p.add_argument("deck", help="path to a JSON deck file")
    p.add_argument("-o", "--output", metavar="FILE.exo",
                   help="override/force Exodus output path")
    p.add_argument("--echo", action="store_true",
                   help="print the fully-resolved deck (reference echo file)")
    p.add_argument("--platform", choices=("cpu", "gpu"), default=None,
                   help="force a JAX platform (default: environment)")
    p.add_argument("--x64", action="store_true",
                   help="enable float64 (recommended on CPU)")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="disable the persistent XLA compilation cache")
    a = p.parse_args(argv)

    import jax

    if a.platform:
        jax.config.update("jax_platforms", a.platform)
    if a.x64:
        jax.config.update("jax_enable_x64", True)
    if not a.no_compile_cache:
        from goma_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    from goma_tpu.input.deck import run_deck

    with open(a.deck) as f:
        deck = json.load(f)
    if a.output:
        deck.setdefault("output", {})["exodus"] = a.output

    prob, result, echo = run_deck(deck)
    if a.echo:
        json.dump(echo, sys.stdout, indent=1, default=str)
        print()

    if hasattr(result, "steps"):  # transient
        conv = all(s.converged for s in result.steps)
        nit = sum(s.newton_iters for s in result.steps)
        print(f"transient: {len(result.steps)} steps, {nit} Newton its, "
              f"t = {result.t:g}, converged = {conv}")
    else:
        conv = bool(result.converged)
        if hasattr(result, "summary"):
            print(result.summary())
        else:  # distributed result: (l1, l2, linf) per iteration
            for k, nrm in enumerate(result.res_norms):
                print(f"  it {k}: ||R||2 = {nrm[1]:.4e}")
        print(f"converged = {conv}")
    return 0 if conv else 1


if __name__ == "__main__":
    sys.exit(main())
