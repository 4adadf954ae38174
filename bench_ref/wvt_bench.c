/* CPU baseline: one WVT relaxation iteration, C99 + OpenMP.
 *
 * The upstream reference (jdonnert/Toycluster) publishes no benchmark
 * numbers and needs GSL (absent here), so this is an independent,
 * optimized CPU implementation of the same per-iteration work used as the
 * measured baseline for bench.py:
 *   - neighbour search over a uniform cell list (stand-in for the
 *     reference's octree walk),
 *   - Wendland-C6 adaptive smoothing-length solve to the kernel-weighted
 *     neighbour-number contract |wkNgb - 295| < 0.05 (Newton + bisection),
 *   - kernel-weighted WVT displacement pass,
 * on a centrally concentrated cloud, OpenMP-parallel over particles.
 *
 * Build: gcc -O3 -march=native -fopenmp -lm
 * Output: one JSON line {"updates_per_sec": ...}
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#ifdef _OPENMP
#include <omp.h>
#endif

#define DESNNGB 295.0
#define NNGBDEV 0.05
#define PI 3.14159265358979323846

static double now_sec(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

static inline float wc6(float r, float h) {
    float u = r / h;
    if (u >= 1.0f) return 0.0f;
    float t = 1.0f - u, t2 = t * t, t4 = t2 * t2;
    return (float)(1365.0 / (64.0 * PI)) / (h * h * h) * t4 * t4
        * (1.0f + u * (8.0f + u * (25.0f + 32.0f * u)));
}

static inline float wc6_flat(float u) {
    if (u >= 1.0f) return 0.0f;
    float t = 1.0f - u, t2 = t * t, t4 = t2 * t2;
    return (float)(1365.0 / (64.0 * PI)) * t4 * t4
        * (1.0f + u * (8.0f + u * (25.0f + 32.0f * u)));
}

static inline float wc6_deriv(float r, float h) {
    float u = r / h;
    if (u >= 1.0f) return 0.0f;
    float t = 1.0f - u, t2 = t * t;
    return (float)(1365.0 / (64.0 * PI)) / (h * h * h * h) * -22.0f
        * t2 * t2 * t2 * t * u * (16.0f * u * u + 7.0f * u + 1.0f);
}

typedef struct {
    int nx, ncell, *head, *next;
    float cell, box;
} Grid;

static void grid_build(Grid *g, const float *pos, int n, float box,
                       float cell) {
    g->box = box;
    g->cell = cell;
    g->nx = (int)(box / cell);
    if (g->nx < 4) g->nx = 4;
    g->cell = box / g->nx;
    g->ncell = g->nx * g->nx * g->nx;
    g->head = realloc(g->head, g->ncell * sizeof(int));
    g->next = realloc(g->next, n * sizeof(int));
    for (int c = 0; c < g->ncell; c++) g->head[c] = -1;
    for (int i = 0; i < n; i++) {
        int ix = (int)(pos[3 * i] / g->cell) % g->nx;
        int iy = (int)(pos[3 * i + 1] / g->cell) % g->nx;
        int iz = (int)(pos[3 * i + 2] / g->cell) % g->nx;
        int c = (ix * g->nx + iy) * g->nx + iz;
        g->next[i] = g->head[c];
        g->head[c] = i;
    }
}

/* pick the coarsest-enough grid level for this radius */
static const Grid *pick_level(const Grid *levels, float radius) {
    for (int l = 0; l < 3; l++)
        if (radius < 4.0f * levels[l].cell || l == 2)
            return &levels[l];
    return &levels[2];
}

/* gather neighbour candidates within radius around particle i */
static int gather(const Grid *g, const float *pos, int i, float radius,
                  int *list, int maxlist) {
    float box = g->box, half = 0.5f * box;
    int nr = (int)(radius / g->cell) + 1;
    if (nr > g->nx / 2) nr = g->nx / 2;  /* periodic wrap limit */
    int ix = (int)(pos[3 * i] / g->cell), iy = (int)(pos[3 * i + 1] / g->cell),
        iz = (int)(pos[3 * i + 2] / g->cell);
    int cnt = 0;
    float r2max = radius * radius;
    for (int dx = -nr; dx <= nr; dx++)
        for (int dy = -nr; dy <= nr; dy++)
            for (int dz = -nr; dz <= nr; dz++) {
                int cx = ((ix + dx) % g->nx + g->nx) % g->nx;
                int cy = ((iy + dy) % g->nx + g->nx) % g->nx;
                int cz = ((iz + dz) % g->nx + g->nx) % g->nx;
                int c = (cx * g->nx + cy) * g->nx + cz;
                for (int j = g->head[c]; j >= 0; j = g->next[j]) {
                    float ddx = pos[3 * i] - pos[3 * j];
                    float ddy = pos[3 * i + 1] - pos[3 * j + 1];
                    float ddz = pos[3 * i + 2] - pos[3 * j + 2];
                    if (ddx > half) ddx -= box; if (ddx < -half) ddx += box;
                    if (ddy > half) ddy -= box; if (ddy < -half) ddy += box;
                    if (ddz > half) ddz -= box; if (ddz < -half) ddz += box;
                    float r2 = ddx * ddx + ddy * ddy + ddz * ddz;
                    if (r2 < r2max && cnt < maxlist) list[cnt++] = j;
                }
            }
    return cnt;
}

int main(int argc, char **argv) {
    int n = argc > 1 ? atoi(argv[1]) : 200000;
    int iters = argc > 2 ? atoi(argv[2]) : 2;
    float box = 1000.0f;

    float *pos = malloc(3ull * n * sizeof(float));
    float *hsml = malloc(n * sizeof(float));
    float *hmetric = malloc(n * sizeof(float));
    float *delta = malloc(3ull * n * sizeof(float));

    /* Plummer sphere (analytic density -> model-based h warm start, the
     * same prior the JAX implementation gets from the beta model) */
    double a_pl = 150.0;
    srand48(42);
    for (int i = 0; i < n; i++) {
        double u = drand48();
        double r = a_pl / sqrt(pow(u, -2.0 / 3.0) - 1.0);
        if (r > 0.45 * box) r = 0.45 * box;
        double ct = 2 * drand48() - 1, ph = 2 * PI * drand48();
        double st = sqrt(1 - ct * ct);
        pos[3 * i] = box / 2 + r * st * cos(ph);
        pos[3 * i + 1] = box / 2 + r * st * sin(ph);
        pos[3 * i + 2] = box / 2 + r * ct;
        /* n(r) = (3 n /(4 pi a^3)) (1+r^2/a^2)^(-5/2) */
        double nloc = 3.0 * n / (4.0 * PI * a_pl * a_pl * a_pl)
            * pow(1.0 + r * r / (a_pl * a_pl), -2.5);
        hsml[i] = cbrt(DESNNGB / (4.0 / 3.0 * PI * nloc));
    }

    /* three grid levels cover the h dynamic range: pick the level whose
     * cell ~ h/3 so the scan stays O(1) cells per particle (the role the
     * reference's adaptive octree plays) */
    Grid levels[3] = {{0}, {0}, {0}};
    const float cell_sizes[3] = {8.0f, 32.0f, 128.0f};
    double t0 = now_sec();
    long long updates = 0;

    for (int it = 0; it < iters + 1; it++) {
        if (it == 1) { t0 = now_sec(); updates = 0; } /* skip cold iter */
        /* rebuild the cell structure every iteration, like
         * TREEBUILDFREQUENCY=1 */
        for (int l = 0; l < 3; l++)
            grid_build(&levels[l], pos, n, box, cell_sizes[l]);

#pragma omp parallel
        {
            int *list = malloc(65536 * sizeof(int));
#pragma omp for schedule(dynamic, 256)
            for (int i = 0; i < n; i++) {
                float h = hsml[i];
                float lo = 0, hi = 4 * h;
                float rsearch = 1.3f * h;
                int cnt = gather(pick_level(levels, rsearch), pos, i,
                                 rsearch, list, 65536);
                for (int itr = 0; itr < 32; itr++) {
                    float wk = 0, rho = 0, drho = 0;
                    for (int k = 0; k < cnt; k++) {
                        int j = list[k];
                        float dx = pos[3*i]-pos[3*j], dy = pos[3*i+1]-pos[3*j+1],
                              dz = pos[3*i+2]-pos[3*j+2];
                        float half = 0.5f * box;
                        if (dx > half) dx -= box; if (dx < -half) dx += box;
                        if (dy > half) dy -= box; if (dy < -half) dy += box;
                        if (dz > half) dz -= box; if (dz < -half) dz += box;
                        float r = sqrtf(dx*dx + dy*dy + dz*dz);
                        float w = wc6(r, h);
                        wk += 4.0f/3.0f*PI * h*h*h * w;
                        rho += w;
                        drho += -(3.0f/h*w + r/h*wc6_deriv(r, h));
                    }
                    float dev = fabsf(wk - DESNNGB);
                    if (dev < NNGBDEV) break;
                    if (dev < 0.5f * DESNNGB) {
                        float omega = 1.0f + drho * h / (3.0f * (rho > 0 ? rho : 1e-30f));
                        float fac = 1.0f - (wk - DESNNGB) / (3.0f * wk * omega);
                        if (fac > 1.24f) fac = 1.24f;
                        if (fac < 1/1.24f) fac = 1/1.24f;
                        h *= fac;
                    } else {
                        if (wk > DESNNGB) hi = h; else lo = h;
                        h = cbrtf(0.5f * (lo*lo*lo + hi*hi*hi));
                    }
                    if (h > rsearch) { /* grew past search radius: research */
                        rsearch = 1.3f * h;
                        cnt = gather(pick_level(levels, rsearch), pos, i,
                                     rsearch, list, 65536);
                    }
                }
                hsml[i] = h;
                hmetric[i] = h / box;
            }

            /* displacement pass */
#pragma omp for schedule(dynamic, 256)
            for (int i = 0; i < n; i++) {
                float dsum[3] = {0, 0, 0};
                int cnt = gather(pick_level(levels, hsml[i]), pos, i,
                                 hsml[i], list, 65536);
                float hi_m = hmetric[i];
                for (int k = 0; k < cnt; k++) {
                    int j = list[k];
                    if (j == i) continue;
                    float dx = (pos[3*i]-pos[3*j]) / box,
                          dy = (pos[3*i+1]-pos[3*j+1]) / box,
                          dz = (pos[3*i+2]-pos[3*j+2]) / box;
                    if (dx > 0.5f) dx -= 1; if (dx < -0.5f) dx += 1;
                    if (dy > 0.5f) dy -= 1; if (dy < -0.5f) dy += 1;
                    if (dz > 0.5f) dz -= 1; if (dz < -0.5f) dz += 1;
                    float r2 = dx*dx + dy*dy + dz*dz;
                    float hb = 0.5f * (hi_m + hmetric[j]);
                    if (r2 > hb * hb || r2 == 0) continue;
                    float r = sqrtf(r2);
                    float w = 0.0085f * hi_m * wc6_flat(r / hb) / r;
                    dsum[0] += w * dx; dsum[1] += w * dy; dsum[2] += w * dz;
                }
                delta[3*i] = dsum[0]; delta[3*i+1] = dsum[1];
                delta[3*i+2] = dsum[2];
            }

            /* move */
#pragma omp for
            for (int i = 0; i < n; i++) {
                for (int d = 0; d < 3; d++) {
                    float p = pos[3*i+d] + delta[3*i+d] * box;
                    while (p < 0) p += box;
                    while (p >= box) p -= box;
                    pos[3*i+d] = p;
                }
            }
            free(list);
        }
        updates += n;
    }

    double dt = now_sec() - t0;
    int nthreads = 1;
#ifdef _OPENMP
#pragma omp parallel
#pragma omp master
    nthreads = omp_get_num_threads();
#endif
    printf("{\"updates_per_sec\": %.1f, \"n\": %d, \"iters\": %d, "
           "\"seconds\": %.3f, \"threads\": %d}\n",
           updates / dt, n, iters, dt, nthreads);
    return 0;
}
