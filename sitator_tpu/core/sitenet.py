"""``SiteNetwork`` — the L3 core data model (API parity target).

Mirrors the reference ``sitator/SiteNetwork.py`` (SURVEY.md §3.1): a host-side
container for a periodic host structure, static/mobile masks, discovered site
``centers``, the per-site static-atom ``vertices`` (landmark polyhedra), and a
generic **attribute system** — named ``(n_sites, ...)`` site attributes and
``(n_sites, n_sites, ...)`` edge attributes that downstream engines attach and
consume by name, and which are automatically remapped by subsetting/merging.

Device notes: the object itself is host-side; device kernels receive its
arrays.  Ragged ``vertices`` are exposed in padded ``(S, V_max)`` + mask form
via :meth:`padded_vertices` so static-shape kernels can consume them.
"""
from __future__ import annotations

import numpy as np

from sitator_tpu.core.structure import Structure

_RESERVED = frozenset({
    "structure", "static_mask", "mobile_mask", "centers", "vertices",
    "site_types", "n_sites", "n_mobile", "n_static",
})


class SiteNetwork:
    def __init__(self, structure: Structure, static_mask, mobile_mask):
        self.structure = structure
        self.static_mask = np.asarray(static_mask, dtype=bool)
        self.mobile_mask = np.asarray(mobile_mask, dtype=bool)
        n = structure.n_atoms
        if self.static_mask.shape != (n,) or self.mobile_mask.shape != (n,):
            raise ValueError("masks must be (n_atoms,)")
        if np.any(self.static_mask & self.mobile_mask):
            raise ValueError("static_mask and mobile_mask overlap")
        self._centers = None          # (S, 3) float
        self._vertices = None         # list of int arrays, len S
        self._site_types = None       # (S,) int
        self._site_attrs = {}         # name -> (S, ...) array
        self._edge_attrs = {}         # name -> (S, S, ...) array

    # -- counts ------------------------------------------------------------
    @property
    def n_sites(self) -> int:
        return 0 if self._centers is None else len(self._centers)

    def __len__(self):
        return self.n_sites

    @property
    def n_static(self) -> int:
        return int(self.static_mask.sum())

    @property
    def n_mobile(self) -> int:
        return int(self.mobile_mask.sum())

    # -- core arrays -------------------------------------------------------
    @property
    def centers(self):
        return self._centers

    @centers.setter
    def centers(self, value):
        value = np.asarray(value, dtype=np.float64)
        if value.ndim != 2 or value.shape[1] != 3:
            raise ValueError("centers must be (n_sites, 3)")
        if self._centers is not None and len(value) != len(self._centers):
            # changing site count invalidates per-site data
            self._vertices = None
            self._site_types = None
            self._site_attrs.clear()
            self._edge_attrs.clear()
        self._centers = value

    @property
    def vertices(self):
        return self._vertices

    @vertices.setter
    def vertices(self, value):
        if value is not None:
            value = [np.asarray(v, dtype=np.int32) for v in value]
            if len(value) != self.n_sites:
                raise ValueError("vertices must have one entry per site")
        self._vertices = value

    @property
    def site_types(self):
        return self._site_types

    @site_types.setter
    def site_types(self, value):
        if value is not None:
            value = np.asarray(value, dtype=np.int32)
            if value.shape != (self.n_sites,):
                raise ValueError("site_types must be (n_sites,)")
        self._site_types = value

    @property
    def has_vertices(self) -> bool:
        return self._vertices is not None

    @property
    def site_ids(self):
        return np.arange(self.n_sites)

    def padded_vertices(self, pad_to=None):
        """Ragged vertices as ``(S, V_max) int32`` indices **into the static
        substructure** plus a ``(S, V_max) bool`` validity mask — the form the
        landmark kernels consume.  Stored vertices index into the full
        structure; this remaps them through ``static_mask``.
        """
        if self._vertices is None:
            raise ValueError("SiteNetwork has no vertices")
        full_to_static = np.full(self.structure.n_atoms, -1, dtype=np.int32)
        full_to_static[self.static_mask] = np.arange(self.n_static)
        vmax = max((len(v) for v in self._vertices), default=1)
        vmax = max(vmax, 1)
        if pad_to is not None:
            if pad_to < vmax:
                raise ValueError(f"pad_to={pad_to} < max vertex count {vmax}")
            vmax = pad_to
        out = np.zeros((self.n_sites, vmax), dtype=np.int32)
        mask = np.zeros((self.n_sites, vmax), dtype=bool)
        for i, v in enumerate(self._vertices):
            sv = full_to_static[v]
            if np.any(sv < 0):
                raise ValueError(f"site {i} has a non-static vertex atom")
            out[i, : len(v)] = sv
            mask[i, : len(v)] = True
        return out, mask

    # -- substructures -----------------------------------------------------
    @property
    def static_structure(self) -> Structure:
        return self.structure[self.static_mask]

    @property
    def mobile_structure(self) -> Structure:
        return self.structure[self.mobile_mask]

    def get_structure_with_sites(self, site_species: int = 0) -> Structure:
        """Full structure plus pseudo-atoms (species ``site_species``, default
        the dummy species X=0) at the site centers — for visualization/export.
        Mirrors the reference's ``get_structure_with_sites``."""
        pos = np.concatenate([self.structure.positions, self.centers], axis=0)
        spec = np.concatenate([
            self.structure.species,
            np.full(self.n_sites, site_species, dtype=np.int32),
        ])
        return Structure(pos, spec, self.structure.cell, self.structure.pbc)

    # -- attribute system --------------------------------------------------
    def add_site_attribute(self, name: str, values):
        values = np.asarray(values)
        if values.shape[:1] != (self.n_sites,):
            raise ValueError(
                f"site attribute {name!r} first dim {values.shape[:1]} != "
                f"(n_sites={self.n_sites},)")
        self._check_name(name)
        self._site_attrs[name] = values

    def add_edge_attribute(self, name: str, values):
        values = np.asarray(values)
        if values.shape[:2] != (self.n_sites, self.n_sites):
            raise ValueError(
                f"edge attribute {name!r} leading dims {values.shape[:2]} != "
                f"(n_sites, n_sites)")
        self._check_name(name)
        self._edge_attrs[name] = values

    def _check_name(self, name: str):
        if name in _RESERVED:
            raise ValueError(f"attribute name {name!r} is reserved")

    @property
    def site_attributes(self):
        return tuple(self._site_attrs)

    @property
    def edge_attributes(self):
        return tuple(self._edge_attrs)

    def has_attribute(self, name: str) -> bool:
        return name in self._site_attrs or name in self._edge_attrs

    def get_site_attribute(self, name: str):
        return self._site_attrs[name]

    def get_edge_attribute(self, name: str):
        return self._edge_attrs[name]

    def remove_attribute(self, name: str):
        if name in self._site_attrs:
            del self._site_attrs[name]
        elif name in self._edge_attrs:
            del self._edge_attrs[name]
        else:
            raise KeyError(name)

    def clear_attributes(self):
        self._site_attrs.clear()
        self._edge_attrs.clear()

    def __getattr__(self, name):
        # Only called when normal lookup fails: expose attributes by name,
        # reference-style (sn.occupancies, sn.n_ij, ...).
        if name.startswith("_"):
            raise AttributeError(name)
        d = self.__dict__
        if name in d.get("_site_attrs", ()):
            return d["_site_attrs"][name]
        if name in d.get("_edge_attrs", ()):
            return d["_edge_attrs"][name]
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}")

    # -- subsetting / remapping -------------------------------------------
    def subset(self, site_indices) -> "SiteNetwork":
        """New ``SiteNetwork`` keeping only ``site_indices`` (index array or
        boolean mask), with every site/edge attribute remapped.  This is the
        primitive under site removal and type selection."""
        site_indices = np.asarray(site_indices)
        if site_indices.dtype == bool:
            site_indices = np.flatnonzero(site_indices)
        sn = SiteNetwork(self.structure, self.static_mask, self.mobile_mask)
        sn._centers = self._centers[site_indices].copy()
        if self._vertices is not None:
            sn._vertices = [self._vertices[i].copy() for i in site_indices]
        if self._site_types is not None:
            sn._site_types = self._site_types[site_indices].copy()
        for k, v in self._site_attrs.items():
            sn._site_attrs[k] = v[site_indices].copy()
        for k, v in self._edge_attrs.items():
            sn._edge_attrs[k] = v[np.ix_(site_indices, site_indices)].copy()
        return sn

    def __getitem__(self, idx) -> "SiteNetwork":
        if isinstance(idx, (int, np.integer)):
            idx = [idx]
        return self.subset(np.asarray(idx))

    def of_type(self, site_type) -> "SiteNetwork":
        """Sub-network of all sites with the given type (reference parity)."""
        if self._site_types is None:
            raise ValueError("SiteNetwork has no site_types")
        return self.subset(self._site_types == site_type)

    @property
    def types(self):
        if self._site_types is None:
            return np.array([], dtype=np.int32)
        return np.unique(self._site_types)

    @property
    def n_types(self) -> int:
        return len(self.types)

    def copy(self) -> "SiteNetwork":
        sn = SiteNetwork(self.structure.copy(), self.static_mask.copy(),
                         self.mobile_mask.copy())
        if self._centers is not None:
            sn._centers = self._centers.copy()
        if self._vertices is not None:
            sn._vertices = [v.copy() for v in self._vertices]
        if self._site_types is not None:
            sn._site_types = self._site_types.copy()
        sn._site_attrs = {k: v.copy() for k, v in self._site_attrs.items()}
        sn._edge_attrs = {k: v.copy() for k, v in self._edge_attrs.items()}
        return sn

    def __repr__(self):
        return (f"SiteNetwork(n_sites={self.n_sites}, n_mobile={self.n_mobile},"
                f" n_static={self.n_static},"
                f" site_attrs={list(self._site_attrs)},"
                f" edge_attrs={list(self._edge_attrs)})")

    # -- serialization (format-versioned .npz) -----------------------------
    _FORMAT_VERSION = 1

    def save(self, file):
        """Save to an ``.npz`` archive (reference ``SiteNetwork.save`` parity)."""
        d = {"__sitenet_version__": np.int64(self._FORMAT_VERSION)}
        d.update(self.structure.to_dict(prefix="structure/"))
        d["static_mask"] = self.static_mask
        d["mobile_mask"] = self.mobile_mask
        if self._centers is not None:
            d["centers"] = self._centers
        if self._vertices is not None:
            d["vertices/concat"] = (
                np.concatenate(self._vertices)
                if self.n_sites else np.zeros(0, dtype=np.int32))
            d["vertices/lengths"] = np.array(
                [len(v) for v in self._vertices], dtype=np.int64)
        if self._site_types is not None:
            d["site_types"] = self._site_types
        for k, v in self._site_attrs.items():
            d[f"site_attr/{k}"] = v
        for k, v in self._edge_attrs.items():
            d[f"edge_attr/{k}"] = v
        np.savez_compressed(file, **d)

    @classmethod
    def load(cls, file) -> "SiteNetwork":
        with np.load(file, allow_pickle=False) as data:
            d = dict(data)
        version = int(d.pop("__sitenet_version__", 1))
        if version > cls._FORMAT_VERSION:
            raise ValueError(f"unsupported SiteNetwork format v{version}")
        structure = Structure.from_dict(d, prefix="structure/")
        sn = cls(structure, d["static_mask"], d["mobile_mask"])
        if "centers" in d:
            sn._centers = d["centers"]
        if "vertices/concat" in d:
            lengths = d["vertices/lengths"]
            offs = np.concatenate([[0], np.cumsum(lengths)])
            sn._vertices = [
                d["vertices/concat"][offs[i]:offs[i + 1]].astype(np.int32)
                for i in range(len(lengths))
            ]
        if "site_types" in d:
            sn._site_types = d["site_types"]
        for k, v in d.items():
            if k.startswith("site_attr/"):
                sn._site_attrs[k[len("site_attr/"):]] = v
            elif k.startswith("edge_attr/"):
                sn._edge_attrs[k[len("edge_attr/"):]] = v
        return sn
