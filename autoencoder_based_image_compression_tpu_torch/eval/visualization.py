"""Figures of the training and of the rate-distortion study (reference
``training_eae_imagenet.py:259-326``,
``reconstructing_eae_kodak.py:245-287``).

``matplotlib`` is imported where a figure is drawn, so that a run that
draws none does not need it.
"""

import numpy


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_nb_dead_feature_maps(rates, nb_deads, path):
    """Dead-feature-map count vs rate (reference
    ``reconstructing_eae_kodak.py:245-287``).

    Accepts 1D arrays (one curve) or 2D ``(nb_points, nb_images)``
    arrays: the per-image curves are overlaid thin with the mean curve
    bold, so one figure carries the whole sweep.
    """
    plt = _pyplot()
    rates = numpy.asarray(rates)
    nb_deads = numpy.asarray(nb_deads)
    if nb_deads.ndim == 2:
        rates_2d = rates if rates.ndim == 2 else numpy.repeat(
            rates[:, None], nb_deads.shape[1], axis=1)
        plt.plot(rates_2d, nb_deads, "-", color="0.8", linewidth=0.6)
        plt.plot(numpy.mean(rates_2d, axis=1), numpy.mean(nb_deads, axis=1),
                 "o-", label="mean over images")
        plt.legend(loc="upper right")
    else:
        plt.plot(rates, nb_deads, "o-")
    plt.xlabel("rate (bpp)")
    plt.ylabel("number of dead feature maps")
    plt.title("Dead latent feature maps vs rate")
    plt.savefig(path)
    plt.clf()


def plot_training_curves(history, path):
    """Loss curves over epochs; ``history`` maps label -> list of values."""
    plt = _pyplot()
    for (label, values) in history.items():
        plt.plot(numpy.arange(len(values)), numpy.asarray(values), label=label)
    plt.xlabel("epoch")
    plt.legend()
    plt.title("Training indicators")
    plt.savefig(path)
    plt.clf()
