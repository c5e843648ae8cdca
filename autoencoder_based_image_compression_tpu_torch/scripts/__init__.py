"""Campaign scripts that chain the port's command lines: the Kodak
rate-distortion campaign (``rd_campaign``), the checkpoint-averaging
stability study (``stability_study``) and the one-process-a-part
training runner (``resilient_campaign``). Each runs as
``python -m autoencoder_based_image_compression_tpu_torch.scripts.<name>``,
on the card unless ``--device cpu`` is given."""
