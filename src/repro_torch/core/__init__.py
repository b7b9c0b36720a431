"""Diffusion core of the port: schedules, noise, transition times, the
decode-update layer and the samplers."""
