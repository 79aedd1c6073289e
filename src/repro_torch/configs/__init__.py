"""Architecture configs the port serves; import through
``repro_torch.config.get_arch``."""
