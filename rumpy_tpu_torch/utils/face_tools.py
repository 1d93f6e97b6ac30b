"""Face tools: detection, alignment, cropping.

Port of ``rumpy_tpu/utils/face_tools.py``. YOLOv3 face detection runs
through OpenCV's DNN module on user-supplied darknet files and is gated on
them; the aligner is a similarity transform from eye landmarks, weight
free. Both import ``cv2`` only when used, so the package imports where
OpenCV is absent. BiSeNet parsing lives in ``utils/face_segmentation.py``
and is re-exported here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from rumpy_tpu_torch.utils.face_segmentation import BiSeNetSegmenter  # noqa: F401


class YoloFaceDetector:
    """YOLOv3 face detection via OpenCV DNN."""

    def __init__(self, cfg_path: Optional[str] = None,
                 weights_path: Optional[str] = None,
                 conf_threshold: float = 0.5, nms_threshold: float = 0.4,
                 input_size: int = 416):
        if not cfg_path or not weights_path:
            raise NotImplementedError(
                "YOLO face detection needs darknet cfg+weights files "
                "(pass cfg_path/weights_path)")
        import cv2
        self.net = cv2.dnn.readNetFromDarknet(cfg_path, weights_path)
        self.conf_threshold = conf_threshold
        self.nms_threshold = nms_threshold
        self.input_size = input_size

    def detect(self, image_bgr: np.ndarray) -> List[Tuple[int, int, int, int]]:
        """(x, y, w, h) boxes of the faces in a BGR uint8 image."""
        import cv2
        h, w = image_bgr.shape[:2]
        blob = cv2.dnn.blobFromImage(image_bgr, 1 / 255.0,
                                     (self.input_size, self.input_size),
                                     swapRB=True, crop=False)
        self.net.setInput(blob)
        outs = self.net.forward(self.net.getUnconnectedOutLayersNames())
        boxes, confs = [], []
        for out in outs:
            for det in out:
                conf = float(det[4])
                if conf > self.conf_threshold:
                    cx, cy, bw, bh = det[0] * w, det[1] * h, det[2] * w, det[3] * h
                    boxes.append([int(cx - bw / 2), int(cy - bh / 2), int(bw), int(bh)])
                    confs.append(conf)
        keep = cv2.dnn.NMSBoxes(boxes, confs, self.conf_threshold, self.nms_threshold)
        return [tuple(boxes[int(i)]) for i in np.asarray(keep).reshape(-1)]


class FaceAligner:
    """Landmark-based alignment: the similarity transform that maps the two
    eye landmarks onto canonical positions of the output."""

    def __init__(self, output_size: Tuple[int, int] = (128, 128),
                 left_eye=(0.35, 0.35), right_eye=(0.65, 0.35)):
        self.output_size = output_size
        self.left_eye = left_eye
        self.right_eye = right_eye

    def align(self, image: np.ndarray,
              landmarks: Sequence[Tuple[float, float]]) -> np.ndarray:
        import cv2
        lm = np.asarray(landmarks, np.float32)
        w, h = self.output_size
        dst = np.float32([[self.left_eye[0] * w, self.left_eye[1] * h],
                          [self.right_eye[0] * w, self.right_eye[1] * h]])
        src = np.float32([lm[0], lm[1]])
        m, _ = cv2.estimateAffinePartial2D(src.reshape(-1, 1, 2), dst.reshape(-1, 1, 2))
        return cv2.warpAffine(image, m, self.output_size)


def crop_faces(image: np.ndarray, detector: YoloFaceDetector,
               margin: float = 0.2) -> List[np.ndarray]:
    """The detector's faces in an RGB image, each box grown by ``margin``."""
    crops = []
    for (x, y, w, h) in detector.detect(image[..., ::-1]):
        mx, my = int(w * margin), int(h * margin)
        x0, y0 = max(0, x - mx), max(0, y - my)
        crops.append(image[y0:y + h + my, x0:x + w + mx])
    return crops
