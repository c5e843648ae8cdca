"""Argparse argument validators (reference
``kodak_tensorflow/parsing/parsing.py:5-101``)."""

import argparse


def float_strictly_positive(string):
    """Argparse type: float > 0."""
    value = float(string)
    if value <= 0.0:
        raise argparse.ArgumentTypeError(f"{string} is not a strictly positive float.")
    return value


def int_positive(string):
    """Argparse type: int >= 0."""
    value = int(string)
    if value < 0:
        raise argparse.ArgumentTypeError(f"{string} is not a positive integer.")
    return value


def int_strictly_positive(string):
    """Argparse type: int > 0."""
    value = int(string)
    if value <= 0:
        raise argparse.ArgumentTypeError(f"{string} is not a strictly positive integer.")
    return value
