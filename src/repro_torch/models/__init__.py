"""Dense decoder model code: layers, attention, MLP, transformer."""
