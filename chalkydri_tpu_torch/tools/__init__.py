"""Card-run tools: the rendered test scenes (``scenes``) and the stage
cost map (``perfprobe``)."""
