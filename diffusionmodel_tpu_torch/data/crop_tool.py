"""Offline dataset builder: RDD2022 annotations -> per-class square crops +
single-object Pascal-VOC XMLs (crop_pic.py:8-217 semantics); the port's
copy of ``diffusionmodel_tpu/data/crop_tool.py`` (host-only: numpy, the
standard library and PIL, imported where an image is cropped).

Crop recipe (crop_pic.py:83-132):
- square side = max(bbox_w, bbox_h) * expand_ratio (default 10.0), centered
  on the bbox center, clamped to the image;
- bbox rescaled into crop coords with scale = target / (new_ymax - new_ymin)
  (the reference scales BOTH axes by the vertical factor — reproduced);
- LANCZOS resize to target (512 in the reference main);
- top third of the crop blacked out (crop_pic.py:128-131);
- JPEG quality 95; idempotent (skips existing outputs).

Output layout (consumed by CrackDataset after a rename to images/):
    save_dir/<class>_<id>/<stem>_obj<k>_crop.jpg
    save_dir/annotations/<stem>_obj<k>_crop.xml

Two annotation ingests:
- Pascal-VOC XML dirs (the reference's input);
- DatasetNinja JSON (the format actually shipped in the repo's
  road-damage-detector-DatasetNinja/: ann/*.jpg.json with
  objects[].classTitle + points.exterior [[x1,y1],[x2,y2]]).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class CropObject:
    name: str
    bbox: Tuple[float, float, float, float]  # xmin, ymin, xmax, ymax


@dataclass
class CropSample:
    img_path: str
    img_name: str
    objects: List[CropObject] = field(default_factory=list)


def parse_voc_dir(img_dir: str, anno_dir: str) -> List[CropSample]:
    samples = []
    for xml_file in sorted(os.listdir(anno_dir)):
        if not xml_file.endswith(".xml"):
            continue
        img_name = xml_file[:-4] + ".jpg"
        img_path = os.path.join(img_dir, img_name)
        if not os.path.exists(img_path):
            continue
        root = ET.parse(os.path.join(anno_dir, xml_file)).getroot()
        objs = []
        for obj in root.findall("object"):
            bb = obj.find("bndbox")
            objs.append(CropObject(
                name=obj.find("name").text,
                bbox=tuple(float(bb.find(k).text)
                           for k in ("xmin", "ymin", "xmax", "ymax")),
            ))
        samples.append(CropSample(img_path, img_name, objs))
    return samples


def parse_datasetninja_dir(img_dir: str, ann_dir: str) -> List[CropSample]:
    """DatasetNinja layout: ann/<image>.json alongside img/<image>."""
    samples = []
    for ann_file in sorted(os.listdir(ann_dir)):
        if not ann_file.endswith(".json"):
            continue
        img_name = ann_file[:-5]  # strip ".json" -> "<name>.jpg"
        img_path = os.path.join(img_dir, img_name)
        if not os.path.exists(img_path):
            continue
        with open(os.path.join(ann_dir, ann_file)) as f:
            ann = json.load(f)
        objs = []
        for obj in ann.get("objects", []):
            pts = obj.get("points", {}).get("exterior", [])
            if len(pts) < 2:
                continue
            xs = [p[0] for p in pts]
            ys = [p[1] for p in pts]
            objs.append(CropObject(
                name=obj.get("classTitle", "unknown"),
                bbox=(min(xs), min(ys), max(xs), max(ys)),
            ))
        samples.append(CropSample(img_path, img_name, objs))
    return samples


def crop_and_resize(image, bbox, target_size: int, expand_ratio: float = 10.0,
                    blackout_top_third: bool = True):
    """Square crop around the bbox -> (resized PIL image, scaled bbox)."""
    from PIL import Image

    xmin, ymin, xmax, ymax = bbox
    side = max(xmax - xmin, ymax - ymin) * expand_ratio
    cx, cy = (xmin + xmax) / 2, (ymin + ymax) / 2
    nx0 = max(0, cx - side / 2)
    ny0 = max(0, cy - side / 2)
    nx1 = min(image.size[0], cx + side / 2)
    ny1 = min(image.size[1], cy + side / 2)

    scale = target_size / (ny1 - ny0)

    def clamp(v):
        return max(0, min(int(v), target_size - 1))

    scaled = [clamp((xmin - nx0) * scale), clamp((ymin - ny0) * scale),
              clamp((xmax - nx0) * scale), clamp((ymax - ny0) * scale)]

    crop = image.crop((nx0, ny0, nx1, ny1)).resize(
        (target_size, target_size), Image.LANCZOS
    )
    if blackout_top_third:
        arr = np.array(crop)
        arr[: target_size // 3, :, :] = 0
        crop = Image.fromarray(arr)
    return crop, scaled


def write_voc_xml(path: str, img_name: str, size: Tuple[int, int],
                  obj_name: str, bbox) -> None:
    root = ET.Element("annotation")
    ET.SubElement(root, "filename").text = img_name
    sz = ET.SubElement(root, "size")
    ET.SubElement(sz, "width").text = str(size[0])
    ET.SubElement(sz, "height").text = str(size[1])
    ET.SubElement(sz, "depth").text = "3"
    obj = ET.SubElement(root, "object")
    ET.SubElement(obj, "name").text = obj_name
    bb = ET.SubElement(obj, "bndbox")
    for k, v in zip(("xmin", "ymin", "xmax", "ymax"), bbox):
        ET.SubElement(bb, k).text = str(v)
    ET.ElementTree(root).write(path, encoding="utf-8", xml_declaration=True)


class DatasetCropper:
    """Process a full annotation set into the per-class crop layout."""

    def __init__(self, samples: List[CropSample], save_dir: str,
                 target_size: int = 512, expand_ratio: float = 10.0):
        self.samples = samples
        self.save_dir = save_dir
        self.target_size = target_size
        self.expand_ratio = expand_ratio
        self.class_map: Dict[str, int] = {}
        os.makedirs(save_dir, exist_ok=True)
        self.anno_dir = os.path.join(save_dir, "annotations")
        os.makedirs(self.anno_dir, exist_ok=True)
        for s in samples:
            for o in s.objects:
                if o.name not in self.class_map:
                    self.class_map[o.name] = len(self.class_map)
                    os.makedirs(self._class_dir(o.name), exist_ok=True)

    def _class_dir(self, name: str) -> str:
        return os.path.join(self.save_dir, f"{name}_{self.class_map[name]}")

    def process_all(self, verbose: bool = False) -> int:
        n = 0
        for sample in self.samples:
            image = None
            for k, obj in enumerate(sample.objects):
                base = os.path.splitext(sample.img_name)[0]
                img_out = os.path.join(self._class_dir(obj.name),
                                       f"{base}_obj{k}_crop.jpg")
                xml_out = os.path.join(self.anno_dir, f"{base}_obj{k}_crop.xml")
                if os.path.exists(img_out) and os.path.exists(xml_out):
                    continue
                if image is None:
                    from PIL import Image

                    image = Image.open(sample.img_path).convert("RGB")
                crop, bbox = crop_and_resize(
                    image, obj.bbox, self.target_size, self.expand_ratio
                )
                crop.save(img_out, quality=95)
                write_voc_xml(xml_out, os.path.basename(img_out),
                              (self.target_size, self.target_size), obj.name, bbox)
                n += 1
            if verbose and n and n % 100 == 0:
                print(f"cropped {n} objects...")
        return n
