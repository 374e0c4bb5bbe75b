"""The port's copies of the host stages of scripts/ that its own code and
chip_smoke.py need."""
