/* Setup-table parity generator: compiles the REFERENCE scene
 * construction (/root/reference/src/setup.c Setup(), with the real
 * param parser io.c:298-507, unit.c, cosmo.c — all UNMODIFIED) against
 * the gslstub QAG + cspline implementations, runs it on a given .par
 * file, and prints every derived halo quantity as machine-readable
 * PARITY lines.  tests/test_setup_parity.py asserts the repo's
 * build_scene() against the committed output (setup_table_cluster.txt)
 * at <=1e-5 relative on every quantity (the reference's own printed
 * table is setup.c:117-142).
 *
 * Usage: gen_setup <parfile>   (build via build.sh) */
#include "globals.h"

int main(int argc, char *argv[])
{
    Assert(argc == 2, "usage: gen_setup <parfile>");

    Omp.NThreads = 1;
    Omp.ThreadID = 0;

    Read_param_file(argv[1]);
    Set_units();
    Set_cosmology();
    Setup();

    printf("PARITY begin\n");
    printf("PARITY global Boxsize %.10e\n", Param.Boxsize);
    printf("PARITY global Mtotal %.10e\n", Param.Mtotal);
    printf("PARITY global Mtot200 %.10e\n", Param.Mtot200);
    printf("PARITY global Mpart0 %.10e\n", Param.Mpart[0]);
    printf("PARITY global Mpart1 %.10e\n", Param.Mpart[1]);
    printf("PARITY global GravSoftening %.10e\n",
           Param.GravSofteningLength);
    printf("PARITY global VelMerger0 %.10e\n", Param.VelMerger[0]);
    printf("PARITY global VelMerger1 %.10e\n", Param.VelMerger[1]);
    for (int i = 0; i < Param.Nhalos; i++) {
        printf("PARITY halo %d Npart0 %lld\n", i, Halo[i].Npart[0]);
        printf("PARITY halo %d Npart1 %lld\n", i, Halo[i].Npart[1]);
        printf("PARITY halo %d Mtotal %.10e\n", i, Halo[i].Mtotal);
        printf("PARITY halo %d Mtotal200 %.10e\n", i,
               Halo[i].Mtotal200);
        printf("PARITY halo %d Mass0 %.10e\n", i, Halo[i].Mass[0]);
        printf("PARITY halo %d Mass1 %.10e\n", i, Halo[i].Mass[1]);
        printf("PARITY halo %d MassCorrFac %.10e\n", i,
               Halo[i].MassCorrFac);
        printf("PARITY halo %d C_nfw %.10e\n", i, Halo[i].C_nfw);
        printf("PARITY halo %d Rs %.10e\n", i, Halo[i].Rs);
        printf("PARITY halo %d R200 %.10e\n", i, Halo[i].R200);
        printf("PARITY halo %d R500 %.10e\n", i, Halo[i].R500);
        printf("PARITY halo %d A_hernq %.10e\n", i, Halo[i].A_hernq);
        printf("PARITY halo %d Rho0 %.10e\n", i, Halo[i].Rho0);
        printf("PARITY halo %d Beta %.10e\n", i, Halo[i].Beta);
        printf("PARITY halo %d Rcore %.10e\n", i, Halo[i].Rcore);
        printf("PARITY halo %d Rcut %.10e\n", i, Halo[i].Rcut);
        printf("PARITY halo %d Bf_eff %.10e\n", i, Halo[i].Bf_eff);
        printf("PARITY halo %d R_Sample0 %.10e\n", i,
               Halo[i].R_Sample[0]);
        printf("PARITY halo %d R_Sample1 %.10e\n", i,
               Halo[i].R_Sample[1]);
        printf("PARITY halo %d D_CoM0 %.10e\n", i, Halo[i].D_CoM[0]);
        printf("PARITY halo %d D_CoM1 %.10e\n", i, Halo[i].D_CoM[1]);
        printf("PARITY halo %d BulkVel0 %.10e\n", i,
               Halo[i].BulkVel[0]);
    }
    printf("PARITY end\n");
    return 0;
}
