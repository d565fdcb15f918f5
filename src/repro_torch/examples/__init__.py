"""Walkthroughs of the port, run as modules (``python -m
repro_torch.examples.<name>``): ``quickstart`` (OCS weight PTQ on a briefly
trained LM), ``serve_quantized`` (the streaming serving API on an
OCS-quantized model) and ``calibrate_activations`` (activation calibration,
clipping, static and Oracle OCS) and ``train_then_quantize`` (train,
checkpoint, then the post-training recipes through ``launch.train``).
Each runs on the card unless given ``--device cpu``.
"""
