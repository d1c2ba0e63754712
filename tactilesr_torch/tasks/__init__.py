"""Training recipes of the port (stage 1: ``tpsf_task``)."""
