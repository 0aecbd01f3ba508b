"""Mitsuba-style scene XML loader (reference: src/librender/xml.cpp).

Python `xml.etree` replaces pugixml; the two-phase design of the reference
(parse to Properties, then instantiate) becomes: parse to plain plugin dicts
(`{"type", "id", "props", "children"}`), then `scene/compiler.py` lowers the
dict graph to flat device arrays.

Semantics mirrored from xml.cpp:
  * `$param` substitution from `<default>` declarations and caller overrides
    (xml.cpp:350-359),
  * nested `<transform>` ops compose as T = op * T — later ops apply after
    earlier ones (xml.cpp:630-661),
  * `<rgb>` synthesizes an `srgb` texture, or `srgb_d65` inside an emitter
    (xml.cpp:530-563),
  * `<spectrum>` synthesizes `uniform` for single values or `regular` for
    "lambda:value, ..." pair lists (xml.cpp:565-628),
  * `<ref id="x">` resolves named top-level objects (xml.cpp:676-710),
  * `<include filename="x.xml">` splices another scene file's children in
    place, `<alias id="x" as="y">` re-binds a named object (xml.cpp tags
    the reference declares but never finished — functional here).
"""

import copy
import re
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from misaki_tpu_torch.core import transform as tr

_OBJECT_TAGS = {
    "scene", "integrator", "sensor", "sampler", "film", "rfilter", "shape",
    "bsdf", "emitter", "texture", "medium", "phase", "volume", "light",
}

_PROP_TAGS = {
    "float", "integer", "boolean", "string", "vector", "point", "rgb",
    "spectrum", "transform", "ref", "default",
}


def _parse_floats(s):
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _substitute(value, params):
    """$name substitution (xml.cpp:350-359)."""
    if "$" not in value:
        return value
    for k in sorted(params, key=len, reverse=True):
        value = value.replace("$" + k, str(params[k]))
    return value


def _parse_vector(node, params, default=0.0):
    if "value" in node.attrib:
        vals = _parse_floats(_substitute(node.get("value"), params))
        if len(vals) == 1:
            vals = vals * 3
        return np.asarray(vals[:3], dtype=np.float64)
    return np.asarray(
        [
            float(_substitute(node.get(a, str(default)), params))
            for a in ("x", "y", "z")
        ],
        dtype=np.float64,
    )


def _parse_transform(node, params):
    """Nested transform ops, composed as `op * T` (xml.cpp:630-661)."""
    t = tr.identity()
    for ch in node:
        tag = ch.tag.lower()
        if tag == "translate":
            t = tr.translate(_parse_vector(ch, params)) @ t
        elif tag == "scale":
            t = tr.scale(_parse_vector(ch, params, default=1.0)) @ t
        elif tag == "rotate":
            axis = _parse_vector(ch, params)
            angle = float(_substitute(ch.get("angle", "0"), params))
            t = tr.rotate(axis, angle) @ t
        elif tag == "lookat":
            origin = np.asarray(_parse_floats(_substitute(ch.get("origin"), params)))
            target = np.asarray(_parse_floats(_substitute(ch.get("target"), params)))
            up = np.asarray(_parse_floats(_substitute(ch.get("up"), params)))
            t = tr.lookat(origin, target, up) @ t
        elif tag == "matrix":
            vals = _parse_floats(_substitute(ch.get("value"), params))
            m = np.asarray(vals, dtype=np.float64).reshape(4, 4)
            t = m @ t
        else:
            raise ValueError(f"Unknown transform op <{ch.tag}>")
    return t


def _rgb_to_texture(node, params, within_emitter):
    """<rgb> -> srgb / srgb_d65 texture plugin (xml.cpp:530-563)."""
    color = _parse_vector(node, params)
    if within_emitter:
        return {
            "type": "srgb_d65",
            "id": "",
            "props": {"color": color, "scale": 1.0},
            "children": [],
        }
    return {"type": "srgb", "id": "", "props": {"color": color}, "children": []}


def _spectrum_to_texture(node, params, within_emitter):
    """<spectrum> -> uniform / regular plugin (xml.cpp:565-628)."""
    value = _substitute(node.get("value", ""), params)
    if ":" in value:
        pairs = [p for p in re.split(r"[,\s]+", value.strip()) if p]
        lams, vals = [], []
        for p in pairs:
            l, v = p.split(":")
            lams.append(float(l))
            vals.append(float(v))
        props = {
            "lambda_min": lams[0],
            "lambda_max": lams[-1],
            "values": np.asarray(vals, dtype=np.float64),
            "within_emitter": within_emitter,
        }
        return {"type": "regular", "id": "", "props": props, "children": []}
    return {
        "type": "uniform",
        "id": "",
        "props": {"value": float(value)},
        "children": [],
    }


def _parse_object(node, params, named, within_emitter=False):
    tag = node.tag.lower()
    if tag == "light":  # old-API alias seen in asset scenes
        tag = "emitter"
    obj = {
        "type": _substitute(node.get("type", tag), params),
        "id": node.get("id", ""),
        "props": {},
        "children": [],
    }
    is_emitter_ctx = within_emitter or tag == "emitter"

    for ch in node:
        ctag = ch.tag.lower()
        name = ch.get("name", "")
        if ctag == "alias":
            src = _substitute(ch.get("id", ""), params)
            dst = _substitute(ch.get("as", ""), params)
            if src not in named:
                raise ValueError(f'<alias id="{src}"> not found')
            named[dst] = named[src]
        elif ctag == "include":
            fname = _substitute(ch.get("filename", ""), params)
            from misaki_tpu_torch.utils.fresolver import get_file_resolver

            inc_path = get_file_resolver().resolve(fname, _CURRENT_BASE[-1])
            inc_root = ET.fromstring(Path(inc_path).read_text())
            if inc_root.tag.lower() != "scene":
                raise ValueError(f"<include> target {fname} is not a <scene>")
            # push the included file's own directory so filenames inside it
            # (nested includes, OBJs) resolve relative to THAT file
            # (advisor r3 #4: they resolved against the top-level scene dir)
            _CURRENT_BASE.append(str(Path(inc_path).parent))
            try:
                inc = _parse_object(inc_root, params, named, within_emitter)
            finally:
                _CURRENT_BASE.pop()
            obj["children"].extend(inc["children"])
            obj["props"].update(
                {k: v for k, v in inc["props"].items()
                 if k not in obj["props"]}
            )
        elif ctag == "default":
            params.setdefault(ch.get("name"), ch.get("value"))
        elif ctag == "float":
            obj["props"][name] = float(_substitute(ch.get("value"), params))
        elif ctag == "integer":
            obj["props"][name] = int(float(_substitute(ch.get("value"), params)))
        elif ctag == "boolean":
            obj["props"][name] = _substitute(ch.get("value"), params).lower() == "true"
        elif ctag == "string":
            obj["props"][name] = _substitute(ch.get("value"), params)
        elif ctag in ("vector", "point"):
            obj["props"][name] = _parse_vector(ch, params)
        elif ctag == "rgb":
            obj["children"].append((name, _rgb_to_texture(ch, params, is_emitter_ctx)))
        elif ctag == "spectrum":
            obj["children"].append(
                (name, _spectrum_to_texture(ch, params, is_emitter_ctx))
            )
        elif ctag == "transform":
            obj["props"][name] = _parse_transform(ch, params)
        elif ctag == "ref":
            ref_id = _substitute(ch.get("id"), params)
            if ref_id not in named:
                raise ValueError(f'<ref id="{ref_id}"> not found')
            obj["children"].append((name, copy.deepcopy(named[ref_id])))
        elif ctag == "texture":
            sub = _parse_object(ch, params, named, is_emitter_ctx)
            obj["children"].append((name, sub))
        elif ctag in _OBJECT_TAGS:
            sub = _parse_object(ch, params, named, is_emitter_ctx)
            if sub["id"]:
                named[sub["id"]] = sub
            obj["children"].append((name, sub))
        elif isinstance(ch.tag, str):
            raise ValueError(f"Unknown tag <{ch.tag}> under <{node.tag}>")
    return obj


# <include> resolution needs the enclosing file's directory; kept as a
# stack so nested includes resolve relative to their own file
_CURRENT_BASE = ["."]


def load_string(text, params=None, base_dir="."):
    """Parse scene XML text -> scene description dict."""
    params = dict(params or {})
    root = ET.fromstring(text)
    if root.tag.lower() != "scene":
        raise ValueError("Root element must be <scene>")
    # Strip XML comments is automatic with ElementTree.
    named = {}
    # Pre-pass: collect top-level named objects so later <ref> can see them
    # even when declared before use (the reference resolves lazily; the asset
    # scenes only reference earlier declarations, so a single pass suffices).
    _CURRENT_BASE.append(str(base_dir))
    try:
        scene = _parse_object(root, params, named)
    finally:
        _CURRENT_BASE.pop()
    scene["base_dir"] = str(base_dir)
    return scene


def load_file(path, params=None):
    path = Path(path)
    return load_string(path.read_text(), params, base_dir=path.parent)
