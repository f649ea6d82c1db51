"""Visualization pipeline: deferred frame rendering from HDF5 snapshots,
energy-history plots, frames → MP4/GIF assembly, and frame thinning (host
only: numpy, matplotlib and Pillow; a copy of ``cfdsim_tpu.viz``)."""

from cfdsim_tpu_torch.viz.frames import render_frames_from_hdf5, plot_energy_history
from cfdsim_tpu_torch.viz.video import make_video
from cfdsim_tpu_torch.viz.cleanup import thin_frames

__all__ = [
    "render_frames_from_hdf5",
    "plot_energy_history",
    "make_video",
    "thin_frames",
]
