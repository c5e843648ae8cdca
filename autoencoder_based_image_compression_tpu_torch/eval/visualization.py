"""Training-curve artifacts (reference ``training_eae_imagenet.py:259-326``).

``matplotlib`` is imported where a figure is drawn, so that a training
run that draws none does not need it.
"""

import numpy


def plot_training_curves(history, path):
    """Loss curves over epochs; ``history`` maps label -> list of values."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for (label, values) in history.items():
        plt.plot(numpy.arange(len(values)), numpy.asarray(values), label=label)
    plt.xlabel("epoch")
    plt.legend()
    plt.title("Training indicators")
    plt.savefig(path)
    plt.clf()
