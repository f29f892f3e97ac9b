// Independent emitter of the reference's boost-serialization "MVS project"
// wire format (uncompressed ARCHIVE_BINARY variant), used to cross-validate
// the Python codec in openmvs_tpu/io/boost_archive.py: two implementations
// of the same documented grammar, written separately, must agree byte for
// byte on the same tiny scene (tests/test_boost_archive.py).
//
// Grammar notes (derived from the reference sources, no code copied):
//   outer header:  "MVS\0" u32 version=1 u32 type=1 u64 reserved=0
//                  (libs/MVS/Scene.cpp:41-42,592-618)
//   class preamble on first encounter: u8 tracking=0, u32 class version=0
//   std::string: u64 length + bytes
//   SEACAVE::cList<T,...,IDX>: IDX-typed count + elements
//                  (libs/Common/List.h:1431-1441)
//   field orders: Scene.h:160, Platform.h:62,83, Camera.h:247,476,
//                 Image.h:112, Interface.h:536, PointCloud.h:114,
//                 Mesh.h:266, OBB.h:112

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <set>
#include <string>

namespace {

struct Emitter {
    FILE* f;
    std::set<std::string> seen;

    void raw(const void* p, size_t n) { fwrite(p, 1, n, f); }
    void u8(uint8_t v) { raw(&v, 1); }
    void u32(uint32_t v) { raw(&v, 4); }
    void i32(int32_t v) { raw(&v, 4); }
    void u64(uint64_t v) { raw(&v, 8); }
    void f32(float v) { raw(&v, 4); }
    void f64(double v) { raw(&v, 8); }
    void str(const char* s) { u64(strlen(s)); raw(s, strlen(s)); }

    // first encounter of a class: tracking flag (off) + class version (0)
    void klass(const char* tag) {
        if (seen.insert(tag).second) { u8(0); u32(0); }
    }

    void point3d(const double* v) {
        klass("TPoint3<double>"); klass("cv::Point3_<double>");
        f64(v[0]); f64(v[1]); f64(v[2]);
    }
    void point3f(const float* v) {
        klass("TPoint3<float>"); klass("cv::Point3_<float>");
        f32(v[0]); f32(v[1]); f32(v[2]);
    }
    void point3u(const uint32_t* v) {
        klass("TPoint3<uint32_t>"); klass("cv::Point3_<uint32_t>");
        u32(v[0]); u32(v[1]); u32(v[2]);
    }
    void mat33d(const double* v) {
        klass("TMatrix<double,3,3>"); klass("cv::Matx<double,3,3>");
        raw(v, 9 * sizeof(double));
    }
    void mat33f(const float* v) {
        klass("TMatrix<float,3,3>"); klass("cv::Matx<float,3,3>");
        raw(v, 9 * sizeof(float));
    }
};

const double kI3[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
const float kI3f[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};

}  // namespace

extern "C" int omvs_emit_test_project(const char* path) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    Emitter e{f, {}};

    // outer container
    e.raw("MVS\0", 4);
    e.u32(1);   // project version
    e.u32(1);   // ARCHIVE_BINARY
    e.u64(0);   // reserved

    // Scene
    e.klass("MVS::Scene");

    // -- platforms: cList<Platform>, uint32 count
    e.klass("cList<Platform>");
    e.u32(1);
    {
        e.klass("MVS::Platform");
        e.klass("SEACAVE::String");
        e.str("rig0");
        // cameras
        e.klass("cList<Camera>");
        e.u32(1);
        {
            e.klass("MVS::Camera");
            e.klass("MVS::CameraIntern");
            const double K[9] = {1.2, 0, 0.5, 0, 1.2, 0.48, 0, 0, 1};
            const double C[3] = {0.01, -0.02, 0.03};
            e.mat33d(K);
            e.mat33d(kI3);
            e.point3d(C);
        }
        // poses
        e.klass("cList<Pose>");
        e.u32(2);
        for (int p = 0; p < 2; ++p) {
            e.klass("MVS::Platform::Pose");
            e.mat33d(kI3);
            const double C[3] = {0.5 * p, 0.0, -0.25 * p};
            e.point3d(C);
        }
    }

    // -- images: cList<Image>, uint32 count
    e.klass("cList<Image>");
    e.u32(2);
    for (uint32_t i = 0; i < 2; ++i) {
        e.klass("MVS::Image");
        e.u32(0);       // platformID
        e.u32(0);       // cameraID
        e.u32(i);       // poseID
        e.u32(7 + i);   // ID
        e.klass("SEACAVE::String");
        e.str(i == 0 ? "images/00000.jpg" : "images/00001.jpg");
        e.str("");      // maskName
        e.u32(640);
        e.u32(480);
        // neighbors: cList<ViewScore>, uint32 count
        e.klass("cList<ViewScore>");
        if (i == 0) {
            e.u32(1);
            e.klass("MVS::ViewScore");
            e.u32(1);       // ID
            e.u32(123);     // points
            e.f32(1.0f);    // scale
            e.f32(0.2f);    // angle
            e.f32(0.8f);    // area
            e.f32(3.5f);    // score
        } else {
            e.u32(0);
        }
        e.f32(2.5f - 0.25f * i);  // avgDepth
    }

    // -- pointcloud (size_t counts)
    e.klass("MVS::PointCloud");
    e.klass("cList<Point3f,size_t>");
    e.u64(3);
    const float pts[3][3] = {{0, 0, 2}, {1, 0, 2.5f}, {0, 1, 3}};
    for (int i = 0; i < 3; ++i) e.point3f(pts[i]);
    // pointViews: cList<ViewArr>, inner cList<uint32> with u32 count
    e.klass("cList<ViewArr,size_t>");
    e.u64(3);
    const uint32_t views[3][2] = {{0, 1}, {0, 0}, {1, 0}};
    const uint32_t nviews[3] = {2, 1, 1};
    for (int i = 0; i < 3; ++i) {
        e.klass("cList<View=u32>");
        e.u32(nviews[i]);
        e.raw(views[i], nviews[i] * 4);
    }
    // pointWeights
    e.klass("cList<WeightArr,size_t>");
    e.u64(3);
    const float wts[3][2] = {{0.5f, 0.25f}, {1.0f, 0}, {2.0f, 0}};
    for (int i = 0; i < 3; ++i) {
        e.klass("cList<Weight=f32>");
        e.u32(nviews[i]);
        e.raw(wts[i], nviews[i] * 4);
    }
    // normals (same cList type as points)
    e.klass("cList<Point3f,size_t>");
    e.u64(3);
    const float nrm[3] = {0, 0, -1};
    for (int i = 0; i < 3; ++i) e.point3f(nrm);
    // colors: cList<Pixel8U,size_t>, elements are 3 raw bytes (BGR)
    e.klass("cList<Pixel8U,size_t>");
    e.u64(3);
    e.klass("SEACAVE::TPixel<u8>");
    const uint8_t cols[9] = {255, 0, 0, 0, 255, 0, 0, 0, 255};
    e.raw(cols, 9);

    // -- mesh
    e.klass("MVS::Mesh");
    e.klass("cList<Vertex,u32>");
    e.u32(3);
    for (int i = 0; i < 3; ++i) e.point3f(pts[i]);
    e.klass("cList<Face,u32>");
    e.u32(1);
    const uint32_t face[3] = {0, 1, 2};
    e.point3u(face);
    // vertexNormals: same type as vertices -> no new preamble, count only
    e.u32(0);
    e.klass("cList<VIdxArr,u32>");   // vertexVertices
    e.u32(0);
    e.u32(0);                        // vertexFaces: same cList type, count only
    e.klass("cList<bool>");          // vertexBoundary (size_t count)
    e.u64(0);
    e.u32(0);                        // faceNormals: same type as vertices
    e.klass("cList<TexCoord,u32>");  // faceTexcoords, PIXEL units
    e.u32(3);
    e.klass("TPoint2<float>");
    e.klass("cv::Point_<float>");
    const float tc[6] = {0.5f, 0.5f, 1.5f, 0.5f, 0.5f, 1.5f};
    e.raw(tc, 6 * 4);
    e.klass("cList<TexIndex=u8,u32>");
    e.u32(1);
    e.u8(0);
    // texturesDiffuse: cList<Image8U3,...,uint8_t> -> 1-BYTE count
    e.klass("cList<Image8U3,u8>");
    e.u8(1);
    {
        e.klass("SEACAVE::TImage<Pixel8U>");
        e.klass("SEACAVE::TDMatrix<Pixel8U>");
        e.klass("cv::Mat_<Pixel8U>");
        e.i32(2);  // cols
        e.i32(2);  // rows
        // TPixel<u8> already registered by pointcloud colors
        const uint8_t tex[12] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12};
        e.raw(tex, 12);
    }

    // -- obb
    e.klass("SEACAVE::TOBB<float,3>");
    e.mat33f(kI3f);
    const float pos[3] = {1, 2, 3}, ext[3] = {4, 5, 6};
    e.point3f(pos);
    e.point3f(ext);

    fclose(f);
    return 0;
}
