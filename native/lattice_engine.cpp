// Native host-side lattice engine for fftisdf_tpu.
//
// The device owns the bulk numerics (JAX/XLA); this library owns the
// scalar-heavy host-side setup work that shapes what the device executes:
//   - lattice-image enumeration for Gaussian decay radii (the image lists
//     drive the AO evaluator's scan length),
//   - momentum-conservation tables (O(nk^3) with hashing),
//   - the real-space part of the Ewald ion-ion energy.
// Python fallbacks exist for every entry point (fftisdf_tpu/native).
//
// Build: g++ -O3 -shared -fPIC lattice_engine.cpp -o liblattice_engine.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 matvec(const double* a /*row-major 3x3*/, double i, double j,
                   double k) {
  // (i, j, k) @ a  with a's rows the lattice vectors
  return {i * a[0] + j * a[3] + k * a[6],
          i * a[1] + j * a[4] + k * a[7],
          i * a[2] + j * a[5] + k * a[8]};
}

inline double norm(const Vec3& v) {
  return std::sqrt(v.x * v.x + v.y * v.y + v.z * v.z);
}

}  // namespace

extern "C" {

// Enumerate lattice translations T = (i,j,k) @ a with
// |center + T - cell_center| <= reach.  Returns the count; writes up to
// max_out translations into out (row-major (n,3)).  nmax gives the integer
// search ranges per axis (precomputed by the caller from lattice heights).
int64_t enumerate_images(const double* a, const double* center,
                         const double* cell_center, double reach,
                         const int64_t* nmax, double* out, int64_t max_out) {
  int64_t count = 0;
  const double dx = center[0] - cell_center[0];
  const double dy = center[1] - cell_center[1];
  const double dz = center[2] - cell_center[2];
  for (int64_t i = -nmax[0]; i <= nmax[0]; ++i) {
    for (int64_t j = -nmax[1]; j <= nmax[1]; ++j) {
      for (int64_t k = -nmax[2]; k <= nmax[2]; ++k) {
        Vec3 t = matvec(a, (double)i, (double)j, (double)k);
        const double px = dx + t.x, py = dy + t.y, pz = dz + t.z;
        if (std::sqrt(px * px + py * py + pz * pz) <= reach) {
          if (count < max_out) {
            out[3 * count + 0] = t.x;
            out[3 * count + 1] = t.y;
            out[3 * count + 2] = t.z;
          }
          ++count;
        }
      }
    }
  }
  return count;
}

// Momentum-conservation tables over scaled k-points (fractional coords).
// kconserv2[k1*nk + k2] = q with s[q] = s[k2] - s[k1] (mod 1)
// kconserv3[(k1*nk + k2)*nk + k3] = k4 with s[k1]-s[k2]+s[k3]-s[k4] = 0 mod 1
// Returns 0 on success, -1 if a required k-point is missing from the set.
static inline int64_t key_of(double f0, double f1, double f2) {
  auto wrap = [](double f) {
    double w = f - std::floor(f);
    // round to 1e-6 grid; values straddling 1.0 wrap to 0
    int64_t r = (int64_t)std::llround(w * 1000000.0);
    if (r >= 1000000) r -= 1000000;
    return r;
  };
  return (wrap(f0) * 2000003LL + wrap(f1)) * 2000003LL + wrap(f2);
}

int32_t build_kconserv(const double* skpts, int64_t nk, int64_t* k2_out,
                       int64_t* k3_out) {
  std::unordered_map<int64_t, int64_t> index;
  index.reserve(2 * nk);
  for (int64_t k = 0; k < nk; ++k) {
    index[key_of(skpts[3 * k], skpts[3 * k + 1], skpts[3 * k + 2])] = k;
  }
  auto lookup = [&](double f0, double f1, double f2) -> int64_t {
    auto it = index.find(key_of(f0, f1, f2));
    return it == index.end() ? -1 : it->second;
  };
  for (int64_t k1 = 0; k1 < nk; ++k1) {
    for (int64_t k2 = 0; k2 < nk; ++k2) {
      const int64_t q = lookup(skpts[3 * k2] - skpts[3 * k1],
                               skpts[3 * k2 + 1] - skpts[3 * k1 + 1],
                               skpts[3 * k2 + 2] - skpts[3 * k1 + 2]);
      if (q < 0) return -1;
      k2_out[k1 * nk + k2] = q;
      for (int64_t k3 = 0; k3 < nk; ++k3) {
        const int64_t k4 =
            lookup(skpts[3 * k1] - skpts[3 * k2] + skpts[3 * k3],
                   skpts[3 * k1 + 1] - skpts[3 * k2 + 1] + skpts[3 * k3 + 1],
                   skpts[3 * k1 + 2] - skpts[3 * k2 + 2] + skpts[3 * k3 + 2]);
        if (k4 < 0) return -1;
        k3_out[(k1 * nk + k2) * nk + k3] = k4;
      }
    }
  }
  return 0;
}

// Periodic Bloch AO evaluation for ONE center group (shells sharing a
// center): out[k, g, f] = sum_T chi_f(r_g - center - T) * e^{i k.T},
// with per-shell image screening (r2 > rcut2[spec] contributes < the
// screening precision and is skipped — the big win over the dense
// (ngrid, nimg) numpy formulation whose temporaries dominate host-side
// selection at production pools; see fftisdf_tpu/basis/eval.py).
//
// Inputs:
//   coords  (ng, 3)  pre-wrapped points (home cell)
//   centers (T, 3)   group.center + images
//   cosk/sink (T, nk) Re/Im of e^{i k.T_image}
//   specs: ls/rpows/nprims/nctrs (nspec,), exps (sum nprim), coeffs
//          (sum nprim*nctr, row-major per spec), rcut2 (nspec)
//   out_re/out_im (nk, ng, nf) — OVERWRITTEN
// Returns nf (the per-group AO count) or -1 on unsupported l.
//
// Real solid harmonics: same coefficients/m-ordering as
// fftisdf_tpu/basis/gto.py::real_solid_harmonics (m = -l..l).
static inline int64_t sph_eval(int64_t l, double dx, double dy, double dz,
                               double* s) {
  const double x2 = dx * dx, y2 = dy * dy, z2 = dz * dz;
  switch (l) {
    case 0:
      s[0] = 0.28209479177387814;
      return 1;
    case 1:
      s[0] = 0.4886025119029199 * dy;
      s[1] = 0.4886025119029199 * dz;
      s[2] = 0.4886025119029199 * dx;
      return 3;
    case 2:
      s[0] = 1.0925484305920792 * dx * dy;
      s[1] = 1.0925484305920792 * dy * dz;
      s[2] = 0.31539156525252005 * (2.0 * z2 - x2 - y2);
      s[3] = 1.0925484305920792 * dx * dz;
      s[4] = 0.5462742152960396 * (x2 - y2);
      return 5;
    case 3:
      s[0] = 0.5900435899266435 * dy * (3.0 * x2 - y2);
      s[1] = 2.890611442640554 * dx * dy * dz;
      s[2] = 0.4570457994644658 * dy * (4.0 * z2 - x2 - y2);
      s[3] = 0.3731763325901154 * dz * (2.0 * z2 - 3.0 * x2 - 3.0 * y2);
      s[4] = 0.4570457994644658 * dx * (4.0 * z2 - x2 - y2);
      s[5] = 1.445305721320277 * dz * (x2 - y2);
      s[6] = 0.5900435899266435 * dx * (x2 - 3.0 * y2);
      return 7;
    case 4: {
      const double r2 = x2 + y2 + z2;
      s[0] = 2.5033429417967046 * dx * dy * (x2 - y2);
      s[1] = 1.7701307697799304 * dy * dz * (3.0 * x2 - y2);
      s[2] = 0.9461746957575601 * dx * dy * (7.0 * z2 - r2);
      s[3] = 0.6690465435572892 * dy * dz * (7.0 * z2 - 3.0 * r2);
      s[4] = 0.10578554691520431 *
             (35.0 * z2 * z2 - 30.0 * z2 * r2 + 3.0 * r2 * r2);
      s[5] = 0.6690465435572892 * dx * dz * (7.0 * z2 - 3.0 * r2);
      s[6] = 0.47308734787878004 * (x2 - y2) * (7.0 * z2 - r2);
      s[7] = 1.7701307697799304 * dx * dz * (x2 - 3.0 * y2);
      s[8] = 0.6258357354491761 *
             (x2 * x2 - 6.0 * x2 * y2 + y2 * y2);
      return 9;
    }
    default:
      return -1;
  }
}

int64_t eval_ao_group(const double* coords, int64_t ng, const double* centers,
                      int64_t nimg, const double* cosk, const double* sink,
                      int64_t nk, int64_t nspec, const int64_t* ls,
                      const int64_t* rpows, const int64_t* nprims,
                      const int64_t* nctrs, const double* exps,
                      const double* coeffs, const double* rcut2,
                      double* out_re, double* out_im) {
  // per-group AO count and max screening radius
  int64_t nf = 0;
  double rcut2max = 0.0;
  for (int64_t s = 0; s < nspec; ++s) {
    if (ls[s] > 4) return -1;
    nf += (2 * ls[s] + 1) * nctrs[s];
    if (rcut2[s] > rcut2max) rcut2max = rcut2[s];
  }
  std::vector<double> chi(nf), sph(9), rad(16), acc_re(nk * nf),
      acc_im(nk * nf);
  for (int64_t g = 0; g < ng; ++g) {
    const double gx = coords[3 * g], gy = coords[3 * g + 1],
                 gz = coords[3 * g + 2];
    std::memset(acc_re.data(), 0, sizeof(double) * nk * nf);
    std::memset(acc_im.data(), 0, sizeof(double) * nk * nf);
    for (int64_t t = 0; t < nimg; ++t) {
      const double dx = gx - centers[3 * t], dy = gy - centers[3 * t + 1],
                   dz = gz - centers[3 * t + 2];
      const double r2 = dx * dx + dy * dy + dz * dz;
      if (r2 > rcut2max) continue;
      // chi for all shells of the group (screened per shell)
      int64_t f0 = 0, p0 = 0, c0 = 0;
      for (int64_t s = 0; s < nspec; ++s) {
        const int64_t np = nprims[s], nc = nctrs[s], nsph = 2 * ls[s] + 1;
        if (r2 > rcut2[s]) {
          std::memset(chi.data() + f0, 0, sizeof(double) * nsph * nc);
        } else {
          if ((int64_t)rad.size() < nc) rad.resize(nc);
          for (int64_t c = 0; c < nc; ++c) rad[c] = 0.0;
          for (int64_t p = 0; p < np; ++p) {
            const double e = std::exp(-r2 * exps[p0 + p]);
            const double* cp = coeffs + c0 + p * nc;
            for (int64_t c = 0; c < nc; ++c) rad[c] += e * cp[c];
          }
          for (int64_t rp = 0; rp < rpows[s]; ++rp)
            for (int64_t c = 0; c < nc; ++c) rad[c] *= r2;
          sph_eval(ls[s], dx, dy, dz, sph.data());
          // layout matches the numpy path: (m, ctr) flattened
          for (int64_t m = 0; m < nsph; ++m)
            for (int64_t c = 0; c < nc; ++c)
              chi[f0 + m * nc + c] = sph[m] * rad[c];
        }
        f0 += nsph * nc;
        p0 += np;
        c0 += np * nc;
      }
      // accumulate with the image's k-phases
      const double* ck = cosk + t * nk;
      const double* sk = sink + t * nk;
      for (int64_t k = 0; k < nk; ++k) {
        const double c = ck[k], si = sk[k];
        double* ar = acc_re.data() + k * nf;
        double* ai = acc_im.data() + k * nf;
        for (int64_t f = 0; f < nf; ++f) {
          ar[f] += c * chi[f];
          ai[f] += si * chi[f];
        }
      }
    }
    for (int64_t k = 0; k < nk; ++k) {
      std::memcpy(out_re + (k * ng + g) * nf, acc_re.data() + k * nf,
                  sizeof(double) * nf);
      std::memcpy(out_im + (k * ng + g) * nf, acc_im.data() + k * nf,
                  sizeof(double) * nf);
    }
  }
  return nf;
}

// Real-space Ewald sum: 0.5 sum_{T, A, B}' Z_A Z_B erfc(sqrt(eta) r)/r
// (self pair A==B at T==0 excluded).  ts: (nt, 3) translations incl. 0.
double ewald_real(const double* coords, const double* charges, int64_t natm,
                  const double* ts, int64_t nt, double eta) {
  const double se = std::sqrt(eta);
  double acc = 0.0;
  for (int64_t t = 0; t < nt; ++t) {
    const double tx = ts[3 * t], ty = ts[3 * t + 1], tz = ts[3 * t + 2];
    const bool origin =
        std::abs(tx) < 1e-12 && std::abs(ty) < 1e-12 && std::abs(tz) < 1e-12;
    for (int64_t aI = 0; aI < natm; ++aI) {
      for (int64_t b = 0; b < natm; ++b) {
        if (origin && aI == b) continue;
        const double rx = coords[3 * aI] - coords[3 * b] + tx;
        const double ry = coords[3 * aI + 1] - coords[3 * b + 1] + ty;
        const double rz = coords[3 * aI + 2] - coords[3 * b + 2] + tz;
        const double r = std::sqrt(rx * rx + ry * ry + rz * rz);
        if (r < 1e-12) continue;
        acc += 0.5 * charges[aI] * charges[b] * std::erfc(se * r) / r;
      }
    }
  }
  return acc;
}

}  // extern "C"
