"""Operator and card-run tools: the configurator CLI and the calibration
solver (``configurator``, ``calibration``), log export and replay
(``logread``), the App soak (``soak``), codebook generation
(``gen_families``), the rendered test scenes (``scenes``), the stage cost
map (``perfprobe``, ``b5_phases``) and the dry run of the row-banded step
(``dryrun``)."""
