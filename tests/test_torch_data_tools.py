"""The port's offline data tools against the JAX package on the CPU:
``data/crop_tool`` (``--mode crop``) and ``data/visualize`` (``--mode
visualize``). Both are host code over PIL, so the files they write must
be the JAX modules' byte for byte (crops, XMLs) or pixel for pixel (the
sheet). The fixtures are those of ``tests/test_data.py`` and
``tests/test_aux.py``."""

import json
import os

import numpy as np
import pytest

from diffusionmodel_tpu.data import CrackDataset as JCrackDataset
from diffusionmodel_tpu.data import crop_tool as jcrop
from diffusionmodel_tpu.data.visualize import (
    visualize_dataset_samples as jvisualize,
)
from diffusionmodel_tpu_torch import cli
from diffusionmodel_tpu_torch.data import CrackDataset
from diffusionmodel_tpu_torch.data import crop_tool as tcrop
from diffusionmodel_tpu_torch.data.visualize import (
    visualize_dataset_samples,
)
from tests.test_data import _write_xml

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _annotated(tmp_path):
    """Two photos with three objects: VOC XMLs and DatasetNinja JSONs."""
    img_dir, voc, ninja = (tmp_path / n for n in ("imgs", "voc", "ninja"))
    for d in (img_dir, voc, ninja):
        d.mkdir()
    rng = np.random.RandomState(3)
    objs = {"a": [("pothole", (40, 40, 60, 70))],
            "b": [("crack", (10, 12, 30, 40)), ("pothole", (70, 20, 90, 35))]}
    for stem, boxes in objs.items():
        Image.fromarray(rng.randint(0, 255, (100, 120, 3), np.uint8)).save(
            img_dir / f"{stem}.jpg")
        _write_xml(str(voc / f"{stem}.xml"), boxes[0][1], size=(120, 100),
                   name=boxes[0][0])
        if len(boxes) > 1:  # a second <object> in the same XML
            import xml.etree.ElementTree as ET

            tree = ET.parse(voc / f"{stem}.xml")
            obj = ET.SubElement(tree.getroot(), "object")
            ET.SubElement(obj, "name").text = boxes[1][0]
            bb = ET.SubElement(obj, "bndbox")
            for k, v in zip(("xmin", "ymin", "xmax", "ymax"), boxes[1][1]):
                ET.SubElement(bb, k).text = str(v)
            tree.write(voc / f"{stem}.xml")
        with open(ninja / f"{stem}.jpg.json", "w") as f:
            json.dump({"objects": [
                {"classTitle": n, "points": {"exterior": [[b[0], b[1]],
                                                          [b[2], b[3]]]}}
                for n, b in boxes]}, f)
    return str(img_dir), str(voc), str(ninja)


@pytest.mark.parametrize("fmt", ["voc", "datasetninja"])
def test_crops_and_xmls_equal_the_jax_modules(fmt, tmp_path):
    img_dir, voc, ninja = _annotated(tmp_path)
    anno = voc if fmt == "voc" else ninja
    parse = "parse_voc_dir" if fmt == "voc" else "parse_datasetninja_dir"
    ours = getattr(tcrop, parse)(img_dir, anno)
    theirs = getattr(jcrop, parse)(img_dir, anno)
    assert [(s.img_name, [(o.name, o.bbox) for o in s.objects])
            for s in ours] == [(s.img_name, [(o.name, o.bbox)
                                             for o in s.objects])
                               for s in theirs]
    a = tcrop.DatasetCropper(ours, str(tmp_path / "port"), target_size=48)
    b = jcrop.DatasetCropper(theirs, str(tmp_path / "jax"), target_size=48)
    assert a.process_all() == b.process_all() == 3
    assert a.class_map == b.class_map
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        assert got[k] == want[k], k
    assert a.process_all() == 0  # idempotent


def test_crop_and_resize_equals_jax():
    img = Image.fromarray(np.random.RandomState(5).randint(
        0, 255, (90, 130, 3), np.uint8))
    for box, size, ratio in (((50, 30, 70, 55), 64, 10.0),
                             ((5, 5, 20, 12), 33, 3.0)):
        c1, b1 = tcrop.crop_and_resize(img, box, size, ratio)
        c2, b2 = jcrop.crop_and_resize(img, box, size, ratio)
        assert b1 == b2
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        assert (np.asarray(c1)[:size // 3] == 0).all()


def _viz_root(tmp_path, n=4):
    root = tmp_path / "ds"
    (root / "images" / "c_0").mkdir(parents=True)
    (root / "annotations").mkdir()
    rng = np.random.RandomState(2)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
            root / "images" / "c_0" / f"i{i}.jpg")
        _write_xml(str(root / "annotations" / f"i{i}.xml"),
                   (10 + i, 20, 40, 50 - i))
    return root


def test_visualize_sheet_equals_jax(tmp_path):
    root = _viz_root(tmp_path)
    ours = visualize_dataset_samples(CrackDataset(str(root), img_size=32),
                                     n_samples=3, seed=4,
                                     out_path=str(tmp_path / "a.png"))
    theirs = jvisualize(JCrackDataset(str(root), img_size=32), n_samples=3,
                        seed=4, out_path=str(tmp_path / "b.png"))
    a, b = (np.asarray(Image.open(p)) for p in (ours, theirs))
    assert a.shape == (3 * 32, 3 * 32, 3)
    np.testing.assert_array_equal(a, b)


def test_cli_crop_and_visualize(tmp_path, capsys):
    img_dir, voc, ninja = _annotated(tmp_path)
    out = tmp_path / "crops"
    assert cli.main(["--mode", "crop", "--img_dir", img_dir, "--anno_dir",
                     ninja, "--anno_format", "datasetninja", "--crop_out",
                     str(out), "--crop_size", "40"]) == 0
    assert "Cropped 3 objects" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["annotations", "crack_1", "pothole_0"]
    assert cli.main(["--mode", "crop", "--img_dir", img_dir]) == 1
    assert "--img_dir and --anno_dir required" in capsys.readouterr().out

    root = _viz_root(tmp_path)
    sheet = tmp_path / "sheet.png"
    assert cli.main(["--mode", "visualize", "--data_root", str(root),
                     "--viz_out", str(sheet), "--samples", "2",
                     "-o", "model.img_size=32"]) == 0
    assert np.asarray(Image.open(sheet)).shape == (64, 96, 3)
    capsys.readouterr()
    assert cli.main(["--mode", "visualize", "--data_root",
                     str(tmp_path / "nope"), "--viz_out",
                     str(tmp_path / "x.png")]) == 1
    assert "Error: no dataset at" in capsys.readouterr().out
    empty = tmp_path / "empty"
    (empty / "images" / "c_0").mkdir(parents=True)
    assert cli.main(["--mode", "visualize", "--data_root", str(empty),
                     "--viz_out", str(tmp_path / "y.png")]) == 1
    assert "no annotated samples" in capsys.readouterr().out
