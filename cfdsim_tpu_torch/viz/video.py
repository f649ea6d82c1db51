"""Frames → MP4/GIF assembly.

The reference shells out to ffmpeg (animate_cylinder.py:20-73,
video_generator.jl:32-79, libx264 MP4 + palette-optimized GIF). A machine
may have no ffmpeg binary, so: MP4 via matplotlib's FFMpegWriter when ffmpeg
exists, GIF via the two-pass palette pipeline — ffmpeg
palettegen/paletteuse (video_generator.jl:32-79) when available, else a
Pillow equivalent (one global adaptive palette quantized from a frame
sample, applied to every frame). fps is auto-computed as
n_frames / duration like the reference (animate_cylinder.py:33-35).
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path


def _sorted_frames(frame_dir, pattern: str = "*.png"):
    return sorted(Path(frame_dir).glob(pattern))


def make_gif_palette(frames, out: Path, fps: float):
    """Two-pass palette-optimized GIF.

    With ffmpeg: exact parity with the reference's palettegen/paletteuse
    pipeline (video_generator.jl:32-79). Without: build one 256-color
    adaptive palette from a sample of frames (median cut over a stacked
    strip) and quantize every frame against it — one global palette like
    palettegen, instead of PillowWriter's per-first-frame palette.
    """
    from PIL import Image

    if shutil.which("ffmpeg"):
        palette = out.with_suffix(".palette.png")
        pattern_dir = Path(frames[0]).parent
        # concat via the glob pattern of the actual frame names
        inputs = ["-framerate", str(fps), "-pattern_type", "glob",
                  "-i", str(pattern_dir / "*.png")]
        subprocess.run(
            ["ffmpeg", "-y", *inputs, "-vf", "palettegen", str(palette)],
            check=True, capture_output=True,
        )
        subprocess.run(
            ["ffmpeg", "-y", *inputs, "-i", str(palette),
             "-lavfi", "paletteuse", str(out)],
            check=True, capture_output=True,
        )
        palette.unlink(missing_ok=True)
        return out

    imgs = [Image.open(f).convert("RGB") for f in frames]
    # pass 1 (palettegen analog): adaptive palette from a frame sample
    sample_idx = range(0, len(imgs), max(1, len(imgs) // 8))
    strip = Image.new("RGB", (imgs[0].width, imgs[0].height * len(list(sample_idx))))
    for row, k in enumerate(sample_idx):
        strip.paste(imgs[k], (0, row * imgs[0].height))
    pal_img = strip.quantize(colors=256)
    # pass 2 (paletteuse analog): quantize every frame to the one palette
    quant = [im.quantize(palette=pal_img) for im in imgs]
    quant[0].save(
        out, save_all=True, append_images=quant[1:],
        duration=int(round(1000.0 / fps)), loop=0, optimize=False,
    )
    return out


def make_video(
    frame_dir,
    out_path,
    duration_s: float = 10.0,
    fps: float | None = None,
    pattern: str = "*.png",
):
    """Assemble the PNGs in ``frame_dir`` into a video.

    Output format follows the ``out_path`` suffix: .mp4 needs ffmpeg
    (falls back to .gif with a warning if absent), .gif always works.
    Returns the path actually written.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt
    from PIL import Image

    frames = _sorted_frames(frame_dir, pattern)
    if not frames:
        raise FileNotFoundError(f"no frames matching {pattern} in {frame_dir}")
    if fps is None:
        fps = max(1.0, len(frames) / duration_s)

    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    want_mp4 = out.suffix.lower() == ".mp4"
    have_ffmpeg = shutil.which("ffmpeg") is not None
    if want_mp4 and not have_ffmpeg:
        out = out.with_suffix(".gif")
        want_mp4 = False
    if not want_mp4:
        # palette-optimized GIF pipeline (reference video_generator.jl:32-79)
        return make_gif_palette(frames, out, fps)

    first = Image.open(frames[0])
    dpi = 100
    fig = plt.figure(figsize=(first.width / dpi, first.height / dpi), dpi=dpi)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.axis("off")
    im = ax.imshow(first)

    def update(i):
        im.set_data(Image.open(frames[i]))
        return [im]

    anim = animation.FuncAnimation(
        fig, update, frames=len(frames), interval=1000.0 / fps, blit=True
    )
    if want_mp4:
        writer = animation.FFMpegWriter(fps=fps, codec="libx264",
                                        extra_args=["-pix_fmt", "yuv420p"])
    else:
        writer = animation.PillowWriter(fps=fps)
    anim.save(out, writer=writer)
    plt.close(fig)
    return out
