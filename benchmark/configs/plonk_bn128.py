"""PLONK on bn128: the squaring-chain family of families/plonk_chain.py."""

from benchmark.families import plonk_chain


def make(config, mix, seed, device):
    return plonk_chain.Cell(config, mix, seed, device)
