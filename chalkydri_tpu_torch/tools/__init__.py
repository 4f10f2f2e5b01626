"""Card-run tools: the rendered test scenes (``scenes``), the stage cost
map (``perfprobe``) and the dry run of the row-banded step (``dryrun``)."""
