"""Branchless wavefront shading.

The reference dispatches `Material::scatter` through a trait object per hit
and returns a 4-way `ScatterResult` enum (reference: src/material.rs:25-47,
src/material/*).  Here we evaluate *all* material models for every lane
with cheap vector math and select by material id — a 7-way one-hot over the
material table, the "expert dispatch" analog of the reference's per-material
branch.  The NEE mixture (camera.rs:297-315) is folded in here: diffuse-type
lanes sample the light-biased mix pdf and return the one-sample MIS weight.

Outputs per lane: emission at this vertex, next ray direction, throughput
weight, and a terminate flag.  The integrator (render/integrator.py) owns
the radiance/throughput recurrences.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax.numpy as jnp

from ..core import math as vmath
from ..core import rng
from ..scene import pack as sp
from . import intersect as isect
from . import lights as lt
from . import texture as tex


class ShadeResult(NamedTuple):
    emission: jnp.ndarray   # (N, 3) radiance emitted at this vertex
    new_dir: jnp.ndarray    # (N, 3) next ray direction (unnormalized, like ref)
    weight: jnp.ndarray     # (N, 3) throughput multiplier for the next segment
    terminate: jnp.ndarray  # (N,) bool — path ends at this vertex


def _random_unit(rng_ctx, stream):
    """Uniform unit vector via normalized gaussian (reference: vec4.rs:42-48)."""
    gx, gy, gz = rng_ctx.gaussian3(stream)
    v = jnp.stack([gx, gy, gz], axis=-1)
    return vmath.normalize(v, 1e-20)


def _cosine_about(normal, rng_ctx, stream):
    """Cosine-weighted direction about `normal` (reference: pdf/cosine.rs)."""
    u1, u2, _, _ = rng_ctx.uniform4(stream)
    local = vmath.square_to_cosine_hemisphere(u1, u2)
    u, v, w = vmath.onb_from_vec(normal)
    return vmath.onb_transform(u, v, w, local)


def shade(
    pack: sp.ScenePack,
    light_list: Sequence[Tuple[int, int]],
    tex_values,            # (T, N, 3) from tex.eval_program
    org, dirn,             # incoming ray
    hit: isect.Hit,
    attr: isect.HitAttributes,
    rng_ctx,
    light_bias: float,
) -> ShadeResult:
    n = org.shape[0]
    dtype = org.dtype
    mat = attr.mat

    unit_dir = vmath.normalize(dirn, 1e-20)

    # ---- per-ray material table gathers: the table is packed into one
    # row table in-jit (it is tiny, the concat folds) so six narrow (N,)
    # gathers become one (N, 6) row gather; gradients flow to the
    # canonical mat_* arrays through the concat ----
    if pack.mat_type.shape[0]:
        mrow = jnp.concatenate(
            [pack.mat_type.astype(dtype)[:, None],
             pack.mat_albedo_tex.astype(dtype)[:, None],
             pack.mat_rough_tex.astype(dtype)[:, None],
             pack.mat_inv_ior[:, None], pack.mat_ior[:, None],
             pack.mat_normal_tex.astype(dtype)[:, None]], axis=1)[mat]
        mtype = mrow[:, 0].astype(jnp.int32)
        albedo = tex.gather_values(tex_values, mrow[:, 1].astype(jnp.int32))
        rough = tex.gather_values(tex_values,
                                  mrow[:, 2].astype(jnp.int32))[:, 0]
        inv_ior = mrow[:, 3]
        ior = mrow[:, 4]
        normal_tex = mrow[:, 5].astype(jnp.int32)
    else:
        mtype = jnp.zeros((n,), jnp.int32)
        albedo = jnp.zeros((n, 3), dtype)
        rough = jnp.zeros((n,), dtype)
        inv_ior = jnp.ones((n,), dtype)
        ior = jnp.ones((n,), dtype)
        normal_tex = jnp.full((n,), -1, jnp.int32)

    # ---- normal mapping (reference: glossy.rs:35-50) ----
    # sampled map in [0,1]^3 -> TBN basis * (sample - 0.5), normalized
    has_nm = normal_tex >= 0
    nm_sample = tex.gather_values(tex_values, jnp.maximum(normal_tex, 0))
    d = nm_sample - 0.5
    mapped = (
        attr.tangent * d[:, 0:1]
        + attr.bitangent * d[:, 1:2]
        + attr.normal * d[:, 2:3]
    )
    mapped = vmath.normalize(mapped, 1e-20)
    nrm_mapped = jnp.where(has_nm[:, None], mapped, attr.normal)

    # ---- emission (reference: emissive.rs:28-34, normal_debug.rs:46-48,
    #      sky.rs / sun.rs implicit Emissive) ----
    emission = jnp.zeros((n, 3), dtype)
    # sky/sun lanes carry a bogus material id (their emission comes from
    # sky_tex/sun_tex); exclude them from material-table emission paths.
    env = (hit.kind == sp.PRIM_SKY) | (hit.kind == sp.PRIM_SUN)
    is_emissive = (mtype == sp.MAT_EMISSIVE) & attr.valid & ~env
    # front-face-only emission rule
    emission = jnp.where(
        (is_emissive & attr.front_face)[:, None], albedo, emission
    )
    is_debug = (mtype == sp.MAT_NORMAL_DEBUG) & attr.valid & ~env
    emission = jnp.where(is_debug[:, None], nrm_mapped * 0.5 + 0.5, emission)
    if pack.sky_tex.shape[0]:
        is_sky = hit.kind == sp.PRIM_SKY
        sky_emit = tex.gather_values(
            tex_values, pack.sky_tex[jnp.maximum(hit.prim, 0)]
        )
        emission = jnp.where(is_sky[:, None], sky_emit, emission)
    if pack.sun_dir.shape[0]:
        is_sun = hit.kind == sp.PRIM_SUN
        sun_emit = tex.gather_values(
            tex_values, pack.sun_tex[jnp.maximum(hit.prim, 0)]
        )
        emission = jnp.where(is_sun[:, None], sun_emit, emission)

    # =====================================================================
    # Specular family: metal / dielectric / glossy-specular
    # =====================================================================
    is_metal = mtype == sp.MAT_METAL
    is_dielectric = mtype == sp.MAT_DIELECTRIC
    is_glossy = mtype == sp.MAT_GLOSSY
    is_lambert = mtype == sp.MAT_LAMBERTIAN
    is_iso = mtype == sp.MAT_ISOTROPIC

    # glossy Schlick coin on the (possibly mapped) normal (glossy.rs:54-60)
    g_cos = jnp.minimum(1.0, vmath.dot(-unit_dir, nrm_mapped))
    g_refl = vmath.reflectance(g_cos, inv_ior)
    u_fresnel = rng_ctx.uniform(rng.Streams.FRESNEL)
    glossy_spec = is_glossy & (g_refl > u_fresnel)

    # metal-style fuzzy reflection (metal.rs:28-35; glossy.rs:61-75).
    # metal reflects about the geometric normal, glossy about the mapped one.
    spec_n = jnp.where(is_metal[:, None], attr.normal, nrm_mapped)
    reflected = vmath.reflect(dirn, spec_n)
    fuzz = _random_unit(rng_ctx, rng.Streams.SPECULAR)
    refl_len = vmath.safe_sqrt(vmath.length_squared(reflected))
    fuzzy_dir = reflected + fuzz * (rough * refl_len)[:, None]
    fuzz_ok = vmath.dot(fuzzy_dir, spec_n) > 0.0

    # dielectric (dielectric.rs:30-53)
    di_ratio = jnp.where(attr.front_face, 1.0 / ior, ior)
    di_cos = jnp.minimum(1.0, vmath.dot(-unit_dir, attr.normal))
    di_sin = vmath.safe_sqrt(1.0 - di_cos * di_cos)
    tir = di_ratio * di_sin > 1.0
    di_reflect = tir | (vmath.reflectance(di_cos, di_ratio) > u_fresnel)
    di_dir = jnp.where(
        di_reflect[:, None],
        vmath.reflect(unit_dir, attr.normal),
        vmath.refract(unit_dir, attr.normal, di_ratio),
    )

    # =====================================================================
    # PDF family: lambertian / isotropic / glossy-diffuse — NEE mixture
    # (camera.rs:297-315)
    # =====================================================================
    pdf_family = is_lambert | is_iso | (is_glossy & ~glossy_spec)
    # material-pdf normal: lambertian uses geometric hit normal, glossy's
    # diffuse lobe the mapped normal (lambertian.rs:26, glossy.rs:77-84)
    cos_n = jnp.where(is_lambert[:, None], attr.normal, nrm_mapped)

    mat_dir = jnp.where(
        is_iso[:, None],
        _random_unit(rng_ctx, rng.Streams.MAT_SAMPLE),
        _cosine_about(cos_n, rng_ctx, rng.Streams.MAT_SAMPLE),
    )
    light_dir = lt.lights_sample(pack, light_list, attr.pos, rng_ctx)
    u_mix = rng_ctx.uniform(rng.Streams.MIX_CHOICE)
    use_light = (u_mix < light_bias) & (len(light_list) > 0)
    nee_dir = jnp.where(use_light[:, None], light_dir, mat_dir)

    # mix pdf value (pdf/mix.rs:23-28)
    unit_nee = vmath.normalize(nee_dir, 1e-20)
    cos_pdf = jnp.maximum(vmath.dot(unit_nee, cos_n), 0.0) / jnp.pi
    iso_pdf = jnp.full((n,), 1.0 / (4.0 * jnp.pi), dtype)
    mat_pdf_val = jnp.where(is_iso, iso_pdf, cos_pdf)
    if light_list:
        light_pdf_val = lt.lights_pdf_value(pack, light_list, attr.pos, nee_dir)
        pdf_val = mat_pdf_val * (1.0 - light_bias) + light_pdf_val * light_bias
    else:
        pdf_val = mat_pdf_val

    # scattering pdf (lambertian.rs:35-43, glossy.rs:86-95, isotropic.rs:35-37)
    scat_pdf = jnp.where(is_iso, iso_pdf, jnp.maximum(vmath.dot(unit_nee, cos_n), 0.0) / jnp.pi)

    safe_pdf = jnp.where(pdf_val > 0.0, pdf_val, 1.0)
    pdf_weight = albedo * (scat_pdf / safe_pdf)[:, None]
    pdf_weight = jnp.where((pdf_val > 0.0)[:, None], pdf_weight, 0.0)

    # =====================================================================
    # Combine
    # =====================================================================
    spec_lane = is_metal | glossy_spec
    new_dir = jnp.where(pdf_family[:, None], nee_dir, jnp.zeros((n, 3), dtype))
    new_dir = jnp.where(spec_lane[:, None], fuzzy_dir, new_dir)
    new_dir = jnp.where(is_dielectric[:, None], di_dir, new_dir)

    weight = jnp.where(pdf_family[:, None], pdf_weight, jnp.zeros((n, 3), dtype))
    # metal: albedo attenuation; glossy specular & dielectric: white
    weight = jnp.where((is_metal & fuzz_ok)[:, None], albedo, weight)
    weight = jnp.where((glossy_spec & fuzz_ok)[:, None], 1.0, weight)
    weight = jnp.where(is_dielectric[:, None], 1.0, weight)

    absorbed = spec_lane & ~fuzz_ok
    terminate = (
        ~attr.valid
        | is_emissive
        | is_debug
        | (hit.kind == sp.PRIM_SKY)
        | (hit.kind == sp.PRIM_SUN)
        | absorbed
    )
    weight = jnp.where(terminate[:, None], 0.0, weight)

    return ShadeResult(
        emission=emission, new_dir=new_dir, weight=weight, terminate=terminate
    )
