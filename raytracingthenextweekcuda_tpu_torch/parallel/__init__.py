"""Tile-sharded rendering and fitting over several devices (counterpart of
raytracingthenextweekcuda_tpu/parallel/)."""
