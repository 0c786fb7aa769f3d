"""Measurement scripts and launchers of the port (counterparts of the
repo's ``scripts/``); ``README.md`` here says which ``chip_smoke.py`` phase
already drives each of the others."""
