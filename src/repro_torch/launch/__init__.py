"""Launchers: mesh construction, the cells' step builders and the dry run
(``python -m repro_torch.launch.dryrun``)."""
