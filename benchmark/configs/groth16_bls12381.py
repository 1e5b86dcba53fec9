"""Groth16 on bls12-381: the squaring-chain family of families/groth16_chain.py."""

from benchmark.families import groth16_chain


def make(config, mix, seed, device):
    return groth16_chain.Cell(config, mix, seed, device)
