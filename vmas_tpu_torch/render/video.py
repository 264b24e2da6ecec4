"""Video saving (counterpart of vmas_tpu/render/video.py).

Writes an ``.mp4`` with cv2, else with imageio, else an ``.npz`` of the
frames: frames are never lost to a broken encoder (imageio without
imageio-ffmpeg raises at write time, not at import time). Frames are host
arrays, as ``Environment.render(mode="rgb_array")`` returns them.
"""

from __future__ import annotations

import numpy as np


def save_video(name: str, frame_list, fps: int):
    """Write ``frame_list`` (``[H, W, 3]`` uint8 RGB arrays) to
    ``name + ".mp4"``, or to ``name + "_frames.npz"`` where neither encoder
    works; returns the path written."""
    frames = [np.asarray(f) for f in frame_list]
    if not frames:
        raise ValueError("save_video: frame_list is empty")
    try:
        import cv2

        h, w = frames[0].shape[0], frames[0].shape[1]
        video = cv2.VideoWriter(name + ".mp4", cv2.VideoWriter_fourcc(*"mp4v"), int(fps), (w, h))
        if not video.isOpened():
            raise RuntimeError("cv2.VideoWriter failed to open")
        try:
            for img in frames:
                # VideoWriter.write drops a frame of another size without
                # raising (a window resized mid-recording): fail into the
                # next backend instead
                if img.shape[0] != h or img.shape[1] != w:
                    raise RuntimeError(f"frame size changed mid-video: {img.shape[:2]} vs ({h}, {w})")
                ok = video.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
                if ok is False:  # some builds return None on success
                    raise RuntimeError("cv2.VideoWriter.write failed")
        finally:
            video.release()
        return name + ".mp4"
    except Exception:
        pass
    try:
        import imageio

        imageio.mimsave(name + ".mp4", frames, fps=int(fps))
        return name + ".mp4"
    except Exception:
        # np.stack fails on ragged sizes; an object array keeps every frame
        if len({f.shape for f in frames}) == 1:
            arr = np.stack(frames)
        else:
            arr = np.empty(len(frames), dtype=object)
            for i, f in enumerate(frames):
                arr[i] = f
        np.savez_compressed(name + "_frames.npz", frames=arr)
        return name + "_frames.npz"
