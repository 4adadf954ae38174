/* WVT-trajectory oracle: compiles the REFERENCE relaxation loop
 * (/root/reference/src/wvt_relax.c Regularise_sph_particles + the full
 * sph.c adaptive-hsml density solve, both UNMODIFIED) with the
 * reference's own in-tree brute-force neighbour finder
 * (wvt_relax.c:296-340, kept "for testing") standing in for the
 * octree: Find_ngb_tree below simply delegates to Find_ngb_simple, and
 * the sort/tree build are no-ops (brute force needs no ordering).  The
 * hsml solve is seeded from the model density instead of the tree's
 * node-density guess — the Newton/bisection solve lands on the same
 * unique h either way (sph.c:80-214).
 *
 * Reads gas positions (raw little-endian float32 xyz, exactly
 * Npart[0] triplets, absolute box coordinates) produced by the repo's
 * sampler so BOTH engines relax the identical initial particle set;
 * the per-iteration "#NN: Err max=... mean=..." lines the loop prints
 * (wvt_relax.c:91-92) ARE the oracle trajectory.
 * tests/test_wvt_refc_parity.py runs both sides.
 *
 * Usage: gen_wvt <parfile> <positions.f32>     (build via build.sh) */
#include "globals.h"

/* ---- tree stand-ins (tree.h) ---- */
int Find_ngb_simple(const int ipart, const float hsml, int *ngblist);

void Build_Tree(void) { }

void Sort_Particles_By_Peano_Key(void) { }

int Find_ngb_tree(const size_t ipart, const float hsml, int *ngblist)
{
    return Find_ngb_simple((int) ipart, hsml, ngblist);
}

float Guess_hsml(const size_t ipart, const int DesNumNgb)
{
    const double rho = Global_density_model((int) ipart);
    return (float) pow(DesNumNgb * Param.Mpart[0] / rho / fourpithird,
                       1.0 / 3.0);
}

int main(int argc, char *argv[])
{
    Assert(argc == 3, "usage: gen_wvt <parfile> <positions.f32>");

    Omp.NThreads = 1;
    Omp.ThreadID = 0;

    Read_param_file(argv[1]);
    Set_units();
    Set_cosmology();
    Setup();

    const long long ngas = Param.Npart[0];
    printf("PARITY ngas %lld\n", ngas);

    FILE *fp = fopen(argv[2], "rb");
    Assert(fp != NULL, "cannot open %s", argv[2]);
    for (long long i = 0; i < ngas; i++) {
        float xyz[3];
        Assert(fread(xyz, sizeof(float), 3, fp) == 3,
               "short read at particle %lld", i);
        P[i].Pos[0] = xyz[0];
        P[i].Pos[1] = xyz[1];
        P[i].Pos[2] = xyz[2];
    }
    fclose(fp);

    Regularise_sph_particles();

    /* final landing state, for the plateau comparison */
    double err_mean = 0, err_max = 0;
    for (long long i = 0; i < ngas; i++) {
        const double rho = Global_density_model((int) i);
        const double err = fabs(SphP[i].Rho - rho) / rho;
        err_mean += err;
        if (err > err_max)
            err_max = err;
    }
    err_mean /= ngas;
    printf("PARITY final err_mean %.6e err_max %.6e\n", err_mean,
           err_max);
    return 0;
}
