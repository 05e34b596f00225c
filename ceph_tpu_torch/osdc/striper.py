"""Striper: logical byte ranges <-> RADOS object extents.

Port of the reference's striping math (ref: src/osdc/Striper.cc
file_to_extents :52-170, extent_to_file :236; layout validation
src/osd/osd_types.cc file_layout_t::is_valid): a file/image is striped
in `stripe_unit` blocks round-robin over `stripe_count` objects per
object set, each object holding `object_size / stripe_unit` stripes'
worth of its column.

    blockno   = off / su
    stripeno  = blockno / sc
    stripepos = blockno % sc
    objectset = stripeno / stripes_per_object
    objectno  = objectset * sc + stripepos
    obj_off   = (stripeno % stripes_per_object) * su + off % su

The port's copy of `ceph_tpu.osdc.striper`.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StripeLayout:
    """file_layout_t subset (ref: src/include/fs_types.h)."""
    stripe_unit: int = 1 << 22
    stripe_count: int = 1
    object_size: int = 1 << 22

    def validate(self) -> None:
        """(ref: file_layout_t::is_valid)."""
        if self.stripe_unit <= 0 or self.stripe_count <= 0 or \
                self.object_size <= 0:
            raise ValueError("layout fields must be positive")
        if self.object_size % self.stripe_unit:
            raise ValueError(
                "object_size must be a multiple of stripe_unit")

    @property
    def stripes_per_object(self) -> int:
        return self.object_size // self.stripe_unit


@dataclass(frozen=True)
class ObjectExtent:
    """One contiguous range inside one object
    (ref: src/osdc/Striper.h ObjectExtent)."""
    objectno: int
    offset: int          # within the object
    length: int
    logical_offset: int  # within the file/image


class Striper:
    @staticmethod
    def file_to_extents(layout: StripeLayout, offset: int,
                        length: int) -> list[ObjectExtent]:
        """(ref: Striper.cc:52 file_to_extents)."""
        layout.validate()
        su = layout.stripe_unit
        sc = layout.stripe_count
        spo = layout.stripes_per_object
        out: list[ObjectExtent] = []
        pos = offset
        end = offset + length
        while pos < end:
            blockno = pos // su
            stripeno = blockno // sc
            stripepos = blockno % sc
            objectset = stripeno // spo
            objectno = objectset * sc + stripepos
            block_start = (stripeno % spo) * su
            block_off = pos % su
            obj_off = block_start + block_off
            n = min(su - block_off, end - pos)
            out.append(ObjectExtent(objectno, obj_off, n, pos))
            pos += n
        return out

    @staticmethod
    def extent_to_file(layout: StripeLayout, objectno: int,
                       off: int, length: int
                       ) -> list[tuple[int, int]]:
        """Object range -> [(logical_offset, len)]
        (ref: Striper.cc:236 extent_to_file)."""
        layout.validate()
        su = layout.stripe_unit
        sc = layout.stripe_count
        spo = layout.stripes_per_object
        objectset = objectno // sc
        stripepos = objectno % sc
        out: list[tuple[int, int]] = []
        pos = off
        end = off + length
        while pos < end:
            stripe_in_obj = pos // su
            off_in_block = pos % su
            stripeno = objectset * spo + stripe_in_obj
            blockno = stripeno * sc + stripepos
            logical = blockno * su + off_in_block
            n = min(su - off_in_block, end - pos)
            out.append((logical, n))
            pos += n
        return out
