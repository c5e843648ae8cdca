"""Builds the dataset artifacts from local source files.

Counterpart of the reference's ``creating_kodak.py``, ``creating_bsds.py``,
``creating_imagenet.py`` and ``creating_extra.py`` folded into
subcommands (the ``svhn`` choice is parsed but its creator is not ported
yet). ``--source_dir`` points at already-fetched
files; ``--download`` opts into fetching missing Kodak/BSDS/SVHN
sources the way the reference's creators do (``data/download.py``).
ILSVRC2012 archives stay manual, as in the reference
(``creating_imagenet.py:30``).
"""

import argparse


def main(args=None):
    parser = argparse.ArgumentParser(description="Creates dataset .npy artifacts.")
    parser.add_argument("dataset", choices=["kodak", "bsds", "imagenet", "extra", "svhn"])
    parser.add_argument("--source_dir", required=True)
    parser.add_argument("--out_dir", default="data")
    parser.add_argument("--nb_training", type=int, default=24000)
    parser.add_argument("--nb_validation", type=int, default=10)
    parser.add_argument("--width_crop", type=int, default=256)
    parser.add_argument("--nb_svhn_training", type=int, default=200000)
    parser.add_argument("--nb_svhn_validation", type=int, default=1000)
    parser.add_argument("--nb_svhn_test", type=int, default=1000)
    parser.add_argument("--download", action="store_true",
                        help="fetch missing source files (kodak/bsds/svhn)")
    args = parser.parse_args(args)

    out = args.out_dir
    if args.dataset == "kodak":
        from autoencoder_based_image_compression_tpu_torch.data.download import (
            ensure_kodak_pngs)
        from autoencoder_based_image_compression_tpu_torch.data.kodak import create_kodak

        if args.download:
            ensure_kodak_pngs(args.source_dir, allow_download=True)
        create_kodak(args.source_dir, f"{out}/kodak/kodak.npy",
                     f"{out}/kodak/list_rotation.pkl")
    elif args.dataset == "bsds":
        from autoencoder_based_image_compression_tpu_torch.data.bsds import create_bsds
        from autoencoder_based_image_compression_tpu_torch.data.download import (
            ensure_bsds_images)

        source_dir = args.source_dir
        if args.download:
            source_dir = ensure_bsds_images(args.source_dir, allow_download=True)
        create_bsds(source_dir, f"{out}/bsds/bsds.npy",
                    f"{out}/bsds/list_rotation.pkl")
    elif args.dataset == "imagenet":
        from autoencoder_based_image_compression_tpu_torch.data.imagenet import (
            create_imagenet_training)

        create_imagenet_training(args.source_dir, f"{out}/imagenet/training_data.npy",
                                 f"{out}/imagenet/validation_data.npy",
                                 args.nb_training, args.nb_validation, args.width_crop)
    elif args.dataset == "extra":
        from autoencoder_based_image_compression_tpu_torch.data.imagenet import create_extra

        create_extra([args.source_dir], f"{out}/extra/extra_data.npy")
    else:
        raise NotImplementedError(
            "create_datasets svhn: not ported yet (SVHN side, queue A14); "
            "data/svhn.py has no counterpart in this package so far.")


if __name__ == "__main__":
    main()
