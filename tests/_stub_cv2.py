"""A stand-in for the part of OpenCV that ``demo/video_demo.py`` (both
packages) uses, over still frames: a capture that reads the given RGB
frames as BGR and a writer that keeps what it is given. Put it in
``sys.modules['cv2']`` for as long as a demo runs; it imports nothing of
either package, so ``chip_smoke.py`` uses it too."""
import types

import numpy as np
from PIL import Image


class StubCv2(types.ModuleType):
    CAP_PROP_FPS, CAP_PROP_FRAME_WIDTH, CAP_PROP_FRAME_HEIGHT = 5, 3, 4
    COLOR_BGR2RGB, COLOR_RGB2BGR = 4, 5

    def __init__(self, frames):
        super().__init__('cv2')
        self.frames, self.written, self.opened = frames, [], None
        stub = self

        class VideoCapture:
            def __init__(self, src):
                self.i = 0

            def isOpened(self):
                return True

            def get(self, prop):
                h, w = stub.frames[0].shape[:2]
                return {5: 25.0, 3: w, 4: h}[prop]

            def read(self):
                if self.i == len(stub.frames):
                    return False, None
                self.i += 1
                return True, stub.frames[self.i - 1][..., ::-1].copy()

            def release(self):
                pass

        class VideoWriter:
            def __init__(self, path, fourcc, fps, size):
                stub.opened = (path, fourcc, fps, size)

            def write(self, frame):
                stub.written.append(frame.copy())

            def release(self):
                pass

        self.VideoCapture, self.VideoWriter = VideoCapture, VideoWriter

    @staticmethod
    def VideoWriter_fourcc(*chars):
        return ''.join(chars)

    @staticmethod
    def cvtColor(img, code):
        return np.ascontiguousarray(img[..., ::-1])

    @staticmethod
    def resize(img, size):
        return np.asarray(Image.fromarray(img).resize(size))
