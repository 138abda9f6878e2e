"""Run configuration — mirrors the reference's parameter set.

The reference declares ~80 module-level run parameters in
``parameter_module.f90`` (param_mod [conf: H]) populated by ``getParams``
from the Fortran namelist file ``LTRANS.data`` (SURVEY.md SS5.6).  We keep
**the same parameter names** in a dataclass so the original run files load
unmodified through :mod:`ltjax.namelist`, and add a handful of
engine-only knobs (dtypes, sharding, prefetch) in a separate section.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from . import namelist as _nml


@dataclass
class Config:
    # --- numparticles ---------------------------------------------------
    numpar: int = 1000            # number of particles

    # --- timeparam ------------------------------------------------------
    days: float = 1.0             # run duration [days]
    iprint: int = 3600            # output interval [s]
    dt: int = 3600                # external step = hydro record spacing [s]
    idt: int = 120                # internal (advection) step [s]

    # --- hydroparam -----------------------------------------------------
    us: int = 20                  # number of rho s-levels
    ws: int = 21                  # number of w s-levels (us+1)
    tdim: int = 24                # time records per history file
    hc: float = 0.2               # s-coordinate critical depth [m]
    z0: float = 0.0005            # bottom roughness height [m]
    Vtransform: int = 1           # ROMS vertical transform (1 or 2)
    readZeta: bool = True
    constZeta: float = 0.0
    readSalt: bool = False
    constSalt: float = 0.0
    readTemp: bool = False
    constTemp: float = 0.0
    readDens: bool = False
    constDens: float = 1025.0
    readU: bool = True
    constU: float = 0.0
    readV: bool = True
    constV: float = 0.0
    readW: bool = True
    constW: float = 0.0
    readAks: bool = True
    constAks: float = 0.0

    # --- turbparam ------------------------------------------------------
    HTurbOn: bool = False
    VTurbOn: bool = False
    ConstantHTurb: float = 1.0    # horizontal diffusivity [m^2/s]
    ConstantVTurb: float = 0.0    # vertical diffusivity if not from Aks

    # --- behavparam -----------------------------------------------------
    Behavior: int = 0             # behavior type 0..7 (SURVEY.md SS2.1 #8)
    OpenOceanBoundary: bool = True
    mortality: bool = False
    deadage: float = 1e30         # age of death [s]
    stochastic_mortality: bool = False  # random death (constant hazard
                                  #   1/deadage; expected lifetime =
                                  #   deadage) instead of deterministic
                                  #   death exactly AT deadage.
                                  #   SURVEY.md SS2.1 #8 [conf: M]
                                  #   reads the reference's mortality
                                  #   as random; both readings are
                                  #   selectable pending mount-return
                                  #   verification (CONSTANTS.md)
    pediage: float = 0.0          # age competent to settle [s]
    swimstart: float = 0.0        # age swimming begins [s]
    swimslow: float = 0.0         # initial swim speed [m/s]
    swimfast: float = 0.0         # final swim speed [m/s]
    Sgradient: float = 1.0        # salinity-gradient cue [psu/m]
    sink: float = 0.0             # sinking velocity (type 6) [m/s]
    Hswimspeed: float = 0.0       # horizontal swim speed (type 7) [m/s]
    Swimdepth: float = 2.0        # swim depth for TST (type 7) [m]

    # --- dvmparam (type 3) ----------------------------------------------
    twistart: float = 4.801821    # time of twilight start [h]
    twiend: float = 19.19956      # time of twilight end [h]
    Em: float = 1935.077          # max. surface irradiance
    Kp: float = 0.4               # light attenuation coefficient [1/m]
    thresh: float = 0.0166        # irradiance threshold

    # --- settleparam ----------------------------------------------------
    settlementon: bool = False
    holesExist: bool = False
    minpolyid: int = 101
    maxpolyid: int = 101
    minholeid: int = 0
    maxholeid: int = 0
    pedges: int = 0               # number of habitat polygon edge rows
    hedges: int = 0               # number of hole polygon edge rows

    # --- convparam ------------------------------------------------------
    PI: float = 3.14159265358979323846
    Earth_Radius: float = 6378e3  # [m]
    SphericalProjection: bool = True
    latmin: float = 0.0           # reference latitude for projection
    lonmin: float = 0.0           # reference longitude for projection

    # --- romsgrid / romsoutput ------------------------------------------
    NCgridfile: str = ""
    dirin: str = ""
    prefix: str = ""
    suffix: str = ".nc"
    filenum: int = 1              # first history-file number
    numdigits: int = 4            # zero padding of file number
    startfile: bool = True        # begin at record 1 of first file

    # --- parloc / habpolyloc --------------------------------------------
    parfile: str = ""             # initial particle CSV
    habitatfile: str = ""         # settlement polygon CSV
    holefile: str = ""            # settlement hole-polygon CSV

    # --- output ---------------------------------------------------------
    outpath: str = "."
    NCOutFile: str = "ltjax_out"
    outpathGiven: bool = True
    writeCSV: bool = False
    writeNC: bool = True
    RunName: str = "ltjax run"
    ExeDir: str = "."
    OutDir: str = "."
    RunBy: str = ""
    Institution: str = ""
    StartedOn: str = ""

    # --- other ----------------------------------------------------------
    seed: int = 9                 # RNG seed
    ErrorFlag: int = 0            # 0 halt on particle error; 1/2/3 flag+continue
    SaltTempOn: bool = False
    TrackCollisions: bool = False
    WriteHeaders: bool = False
    WriteModelTiming: bool = False
    WriteParfile: bool = False
    BoundaryBLNs: bool = False

    # --- engine-only knobs (no reference analog) -------------------------
    dtype_pos: str = "float64"    # particle position dtype ("float64" for
                                  #   reference comparisons, "float32" in
                                  #   the benchmark cells)
    dtype_field: str = "float32"  # field gather/interpolation dtype
    tension_sigma: float = 0.0    # uniform dimensionless spline tension;
                                  #   <0 => adaptive (SIGS-like) selection
    fast_interp: bool = True      # packed-table interpolation path
                                  #   (ltjax.packed): time-collapse-first
                                  #   + per-column splines; False =>
                                  #   reference-ordered native path
    reflect_iters: int = 4        # fixed boundary-reflection iteration count
    mesh_particles: int = 1       # mesh axis size: particle data-parallel
    mesh_tiles: int = 1           # mesh axis size: domain tiles (eta strips)
    migrate_capacity: float = 1.5 # per-tile particle buffer slack factor
    halo_rows: int = 4            # halo rows per tile side (must cover
                                  #   max displacement per external step
                                  #   + 1 stencil row; shard.halo_rows_needed)
    prefetch: bool = True         # async host->device field prefetch
    checkpoint_every: int = 0     # external steps between checkpoints (0=off)
    checkpoint_dir: str = "ckpt"

    # ---------------------------------------------------------------------
    def needs_salt_fields(self) -> bool:
        """Salt (and temp) fields are needed when sampling is on OR a
        salinity-cued behavior (4/5) runs — keying them on SaltTempOn
        alone silently zeroes the halocline cue."""
        return self.SaltTempOn or self.Behavior in (4, 5)

    @property
    def external_steps(self) -> int:
        return int(round(self.days * 86400.0 / self.dt))

    @property
    def internal_steps(self) -> int:
        assert self.dt % self.idt == 0, "dt must be a multiple of idt"
        return self.dt // self.idt

    @property
    def output_every_ext(self) -> int:
        """External steps between outputs."""
        return max(1, self.iprint // self.dt)

    def validate(self) -> None:
        if self.dt % self.idt != 0:
            raise ValueError(f"dt={self.dt} not a multiple of idt={self.idt}")
        if self.Vtransform not in (1, 2):
            raise ValueError(f"Vtransform must be 1 or 2, got {self.Vtransform}")
        if not 0 <= self.Behavior <= 7:
            raise ValueError(f"Behavior must be in 0..7, got {self.Behavior}")
        if self.ws != self.us + 1:
            raise ValueError(f"ws ({self.ws}) must equal us+1 ({self.us + 1})")
        if self.Behavior in (4, 5) and not self.readSalt:
            # oyster-larva ontogenetic migration (types 4/5) cues on the
            # vertical salinity gradient (behavior_module.f90, SURVEY.md
            # SS2.1 #8); without salt fields the cue is silently zero.
            # (SaltTempOn is NOT required: needs_salt_fields() loads the
            # salt fields for the cue regardless of output sampling.)
            raise ValueError(
                f"Behavior={self.Behavior} (salinity-cued ontogenetic "
                "migration) requires readSalt — without salt fields "
                "the dS/dz cue is identically zero")


_FIELDS = {f.name.lower(): f.name for f in dataclasses.fields(Config)}


def config_from_namelist(path: str, **overrides) -> Config:
    """Load a Config from an ``LTRANS.data``-style namelist file.

    Unknown keys are ignored with a note (forward compatibility with
    reference run files); ``overrides`` win over file values.
    """
    flat = _nml.flatten(_nml.read_namelist(path))
    kwargs = {}
    for k, v in flat.items():
        name = _FIELDS.get(k.lower())
        if name is not None:
            kwargs[name] = v
    kwargs.update(overrides)
    cfg = Config(**kwargs)
    cfg.validate()
    return cfg
