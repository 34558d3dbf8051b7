// Native asset-packing core: fast OBJ/MTL parsing, vertex welding, smooth
// normals, Lengyel tangents, Morton triangle ordering.
//
// The reference engine's loader path is C++ (Assimp behind
// Loader/ModelLoader.cpp); this is the JAX build's native equivalent for
// the host-side hot path: parsing + packing big meshes into the shared
// vertex/index buffers the device consumes. Exposed via a C ABI for
// ctypes; trident.assets.native falls back to the pure-Python loader
// when the shared object is unavailable.
//
// Build: g++ -O3 -march=native -shared -fPIC loader.cpp -o libttnative.so

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vec2 { float x = 0, y = 0; };
struct Vec3 { float x = 0, y = 0, z = 0; };

struct Material {
    float base_color[4] = {1, 1, 1, 1};
    float metallic = 0.0f;
    float roughness = 1.0f;
    std::string name;
    std::string texture;  // resolved map_Kd path ("" = none)
};

struct Mesh {
    std::vector<float> positions;   // 3*V
    std::vector<float> normals;     // 3*V
    std::vector<float> tangents;    // 3*V
    std::vector<float> bitangents;  // 3*V
    std::vector<float> uvs;         // 2*V
    std::vector<int32_t> indices;   // 3*T
    int material = 0;
    std::string name;
};

struct Model {
    std::vector<Mesh> meshes;
    std::vector<Material> materials;
};

// -- tiny fast parsing helpers -------------------------------------------------

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* parse_float(const char* p, const char* end, float* out) {
    p = skip_ws(p, end);
    char* q = nullptr;
    *out = std::strtof(p, &q);
    return q ? q : p;
}

inline const char* parse_int(const char* p, const char* end, long* out) {
    p = skip_ws(p, end);
    char* q = nullptr;
    *out = std::strtol(p, &q, 10);
    return q ? q : p;
}

struct Key {
    int32_t v, t, n;
    bool operator==(const Key& o) const { return v == o.v && t == o.t && n == o.n; }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t h = (uint64_t)(uint32_t)k.v * 0x9E3779B97F4A7C15ull;
        h ^= (uint64_t)(uint32_t)k.t * 0xC2B2AE3D27D4EB4Full + (h << 6);
        h ^= (uint64_t)(uint32_t)k.n * 0x165667B19E3779F9ull + (h >> 3);
        return (size_t)h;
    }
};

// -- geometry post-processing ----------------------------------------------------

void compute_normals(Mesh& m) {
    size_t v = m.positions.size() / 3;
    m.normals.assign(3 * v, 0.0f);
    const float* P = m.positions.data();
    for (size_t i = 0; i + 2 < m.indices.size(); i += 3) {
        int a = m.indices[i], b = m.indices[i + 1], c = m.indices[i + 2];
        float e1x = P[3*b] - P[3*a], e1y = P[3*b+1] - P[3*a+1], e1z = P[3*b+2] - P[3*a+2];
        float e2x = P[3*c] - P[3*a], e2y = P[3*c+1] - P[3*a+1], e2z = P[3*c+2] - P[3*a+2];
        float nx = e1y * e2z - e1z * e2y;
        float ny = e1z * e2x - e1x * e2z;
        float nz = e1x * e2y - e1y * e2x;
        for (int k : {a, b, c}) {
            m.normals[3*k] += nx; m.normals[3*k+1] += ny; m.normals[3*k+2] += nz;
        }
    }
    for (size_t i = 0; i < v; ++i) {
        float* n = &m.normals[3*i];
        float len = std::sqrt(n[0]*n[0] + n[1]*n[1] + n[2]*n[2]);
        if (len < 1e-12f) { n[2] = 1.0f; continue; }
        n[0] /= len; n[1] /= len; n[2] /= len;
    }
}

void compute_tangents(Mesh& m) {
    size_t v = m.positions.size() / 3;
    std::vector<double> tan(3 * v, 0.0), bit(3 * v, 0.0);
    const float* P = m.positions.data();
    const float* U = m.uvs.data();
    for (size_t i = 0; i + 2 < m.indices.size(); i += 3) {
        int a = m.indices[i], b = m.indices[i + 1], c = m.indices[i + 2];
        double e1[3] = {P[3*b]-P[3*a], P[3*b+1]-P[3*a+1], P[3*b+2]-P[3*a+2]};
        double e2[3] = {P[3*c]-P[3*a], P[3*c+1]-P[3*a+1], P[3*c+2]-P[3*a+2]};
        double d1u = U[2*b]-U[2*a], d1v = U[2*b+1]-U[2*a+1];
        double d2u = U[2*c]-U[2*a], d2v = U[2*c+1]-U[2*a+1];
        double det = d1u * d2v - d2u * d1v;
        double r = std::fabs(det) < 1e-12 ? 0.0 : 1.0 / det;
        for (int j = 0; j < 3; ++j) {
            double t = (e1[j] * d2v - e2[j] * d1v) * r;
            double bb = (e2[j] * d1u - e1[j] * d2u) * r;
            for (int k : {a, b, c}) { tan[3*k+j] += t; bit[3*k+j] += bb; }
        }
    }
    m.tangents.assign(3 * v, 0.0f);
    m.bitangents.assign(3 * v, 0.0f);
    for (size_t i = 0; i < v; ++i) {
        const float* n = &m.normals[3*i];
        double t[3] = {tan[3*i], tan[3*i+1], tan[3*i+2]};
        double dot = t[0]*n[0] + t[1]*n[1] + t[2]*n[2];
        for (int j = 0; j < 3; ++j) t[j] -= n[j] * dot;   // Gram-Schmidt
        double len = std::sqrt(t[0]*t[0] + t[1]*t[1] + t[2]*t[2]);
        if (len < 1e-8) { m.tangents[3*i] = 1.0f; }
        else for (int j = 0; j < 3; ++j) m.tangents[3*i+j] = (float)(t[j] / len);
        double b[3] = {bit[3*i], bit[3*i+1], bit[3*i+2]};
        double bl = std::sqrt(b[0]*b[0] + b[1]*b[1] + b[2]*b[2]);
        if (bl < 1e-8) {  // n × t
            m.bitangents[3*i]   = n[1]*m.tangents[3*i+2] - n[2]*m.tangents[3*i+1];
            m.bitangents[3*i+1] = n[2]*m.tangents[3*i]   - n[0]*m.tangents[3*i+2];
            m.bitangents[3*i+2] = n[0]*m.tangents[3*i+1] - n[1]*m.tangents[3*i];
        } else for (int j = 0; j < 3; ++j) m.bitangents[3*i+j] = (float)(b[j] / bl);
    }
}

inline uint64_t part1by2(uint64_t x) {
    x &= 0x3FF;
    x = (x | (x << 16)) & 0x030000FF;
    x = (x | (x << 8)) & 0x0300F00F;
    x = (x | (x << 4)) & 0x030C30C3;
    x = (x | (x << 2)) & 0x09249249;
    return x;
}

// Morton-order triangles by centroid so consecutive triangles are spatially
// coherent (the raster binner's chunk bboxes depend on it).
void morton_sort(Mesh& m) {
    size_t t = m.indices.size() / 3;
    if (t <= 2) return;
    const float* P = m.positions.data();
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    std::vector<float> cx(t), cy(t), cz(t);
    for (size_t i = 0; i < t; ++i) {
        int a = m.indices[3*i], b = m.indices[3*i+1], c = m.indices[3*i+2];
        float q[3];
        for (int j = 0; j < 3; ++j) {
            q[j] = (P[3*a+j] + P[3*b+j] + P[3*c+j]) / 3.0f;
            if (q[j] < lo[j]) lo[j] = q[j];
            if (q[j] > hi[j]) hi[j] = q[j];
        }
        cx[i] = q[0]; cy[i] = q[1]; cz[i] = q[2];
    }
    float span[3];
    for (int j = 0; j < 3; ++j) span[j] = std::max(hi[j] - lo[j], 1e-12f);
    std::vector<std::pair<uint64_t, uint32_t>> keys(t);
    for (size_t i = 0; i < t; ++i) {
        auto quant = [&](float v, int j) -> uint64_t {
            float f = (v - lo[j]) / span[j] * 1023.0f;
            long q = lrintf(std::floor(f));
            if (q < 0) q = 0; if (q > 1023) q = 1023;
            return (uint64_t)q;
        };
        uint64_t code = part1by2(quant(cx[i], 0))
                      | (part1by2(quant(cy[i], 1)) << 1)
                      | (part1by2(quant(cz[i], 2)) << 2);
        keys[i] = {code, (uint32_t)i};
    }
    std::stable_sort(keys.begin(), keys.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    std::vector<int32_t> out(m.indices.size());
    for (size_t i = 0; i < t; ++i) {
        uint32_t src = keys[i].second;
        out[3*i] = m.indices[3*src];
        out[3*i+1] = m.indices[3*src+1];
        out[3*i+2] = m.indices[3*src+2];
    }
    m.indices.swap(out);
}

std::string dir_of(const std::string& path) {
    size_t pos = path.find_last_of("/\\");
    return pos == std::string::npos ? std::string(".") : path.substr(0, pos);
}

bool read_file(const std::string& path, std::string& out) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out.resize((size_t)size);
    size_t got = std::fread(&out[0], 1, (size_t)size, f);
    std::fclose(f);
    out.resize(got);
    return true;
}

void parse_mtl(const std::string& path, std::vector<Material>& mats,
               std::unordered_map<std::string, int>& by_name) {
    std::string text;
    if (!read_file(path, text)) return;
    const char* p = text.data();
    const char* end = p + text.size();
    Material* cur = nullptr;
    std::string base = dir_of(path);
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);
        if (line_end - q >= 6 && !strncmp(q, "newmtl", 6)) {
            const char* s = skip_ws(q + 6, line_end);
            std::string name(s, (size_t)(line_end - s));
            while (!name.empty() && (name.back() == '\r' || name.back() == ' ')) name.pop_back();
            by_name[name] = (int)mats.size();
            mats.emplace_back();
            cur = &mats.back();
            cur->name = name;
        } else if (cur && line_end - q >= 2 && q[0] == 'K' && q[1] == 'd') {
            const char* s = q + 2;
            s = parse_float(s, line_end, &cur->base_color[0]);
            s = parse_float(s, line_end, &cur->base_color[1]);
            parse_float(s, line_end, &cur->base_color[2]);
        } else if (cur && line_end - q >= 2 && q[0] == 'N' && q[1] == 's') {
            float ns = 0; parse_float(q + 2, line_end, &ns);
            float r = std::sqrt(2.0f / (ns + 2.0f));
            cur->roughness = r < 0.045f ? 0.045f : (r > 1.0f ? 1.0f : r);
        } else if (cur && line_end - q >= 2 && q[0] == 'P' && q[1] == 'm') {
            parse_float(q + 2, line_end, &cur->metallic);
        } else if (cur && line_end - q >= 2 && q[0] == 'P' && q[1] == 'r') {
            parse_float(q + 2, line_end, &cur->roughness);
        } else if (cur && line_end - q >= 6 && !strncmp(q, "map_Kd", 6)) {
            const char* s = skip_ws(q + 6, line_end);
            std::string rel(s, (size_t)(line_end - s));
            while (!rel.empty() && (rel.back() == '\r' || rel.back() == ' ')) rel.pop_back();
            cur->texture = base + "/" + rel;
        }
        p = line_end + 1;
    }
}

}  // namespace

extern "C" {

struct TTModel {
    Model model;
};

TTModel* tt_load_obj(const char* path) {
    std::string text;
    if (!read_file(path, text)) return nullptr;

    auto* handle = new TTModel();
    Model& model = handle->model;
    std::string base = dir_of(path);

    std::vector<Vec3> positions, normals;
    std::vector<Vec2> uvs;
    std::unordered_map<std::string, int> mat_by_name;

    struct Group {
        std::vector<Key> corners;  // 3 per triangle
        int material = 0;
        std::string name;
    };
    std::vector<Group> groups;
    std::unordered_map<std::string, int> group_by_mat;
    Group* cur = nullptr;

    auto group_for = [&](const std::string& matname) -> Group* {
        auto it = group_by_mat.find(matname);
        if (it != group_by_mat.end()) return &groups[it->second];
        group_by_mat[matname] = (int)groups.size();
        groups.emplace_back();
        Group* g = &groups.back();
        g->name = matname;
        auto mit = mat_by_name.find(matname);
        g->material = mit == mat_by_name.end() ? 0 : mit->second;
        return g;
    };

    const char* p = text.data();
    const char* end = p + text.size();
    std::vector<Key> face;  // scratch
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', (size_t)(end - p));
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);
        if (q < line_end) {
            if (q[0] == 'v' && q + 1 < line_end && q[1] == ' ') {
                Vec3 v; const char* s = q + 1;
                s = parse_float(s, line_end, &v.x);
                s = parse_float(s, line_end, &v.y);
                parse_float(s, line_end, &v.z);
                positions.push_back(v);
            } else if (q[0] == 'v' && q + 1 < line_end && q[1] == 't') {
                Vec2 v; const char* s = q + 2;
                s = parse_float(s, line_end, &v.x);
                parse_float(s, line_end, &v.y);
                uvs.push_back(v);
            } else if (q[0] == 'v' && q + 1 < line_end && q[1] == 'n') {
                Vec3 v; const char* s = q + 2;
                s = parse_float(s, line_end, &v.x);
                s = parse_float(s, line_end, &v.y);
                parse_float(s, line_end, &v.z);
                normals.push_back(v);
            } else if (!strncmp(q, "mtllib", 6)) {
                const char* s = skip_ws(q + 6, line_end);
                std::string rel(s, (size_t)(line_end - s));
                while (!rel.empty() && (rel.back() == '\r' || rel.back() == ' ')) rel.pop_back();
                parse_mtl(base + "/" + rel, model.materials, mat_by_name);
            } else if (!strncmp(q, "usemtl", 6)) {
                const char* s = skip_ws(q + 6, line_end);
                std::string name(s, (size_t)(line_end - s));
                while (!name.empty() && (name.back() == '\r' || name.back() == ' ')) name.pop_back();
                cur = group_for(name);
            } else if (q[0] == 'f' && q + 1 < line_end && q[1] == ' ') {
                if (!cur) cur = group_for("");
                face.clear();
                const char* s = q + 1;
                while (true) {
                    s = skip_ws(s, line_end);
                    if (s >= line_end || !(std::isdigit((unsigned char)*s) || *s == '-')) break;
                    long vi = 0, ti = 0, ni = 0;
                    const char* before = s;
                    s = parse_int(s, line_end, &vi);
                    if (s == before) break;  // bare '-' (no digits): strtol
                                             // makes no progress — a stuck
                                             // cursor here loops forever
                                             // on malformed files
                    bool has_t = false, has_n = false;
                    if (s < line_end && *s == '/') {
                        ++s;
                        if (s < line_end && *s != '/') { s = parse_int(s, line_end, &ti); has_t = true; }
                        if (s < line_end && *s == '/') { ++s; s = parse_int(s, line_end, &ni); has_n = true; }
                    }
                    Key k;
                    k.v = (int32_t)(vi > 0 ? vi - 1 : (long)positions.size() + vi);
                    k.t = has_t ? (int32_t)(ti > 0 ? ti - 1 : (long)uvs.size() + ti) : -1;
                    k.n = has_n ? (int32_t)(ni > 0 ? ni - 1 : (long)normals.size() + ni) : -1;
                    face.push_back(k);
                }
                // fan-triangulate, REVERSED winding (OBJ CCW → engine convention)
                for (size_t i = 1; i + 1 < face.size(); ++i) {
                    cur->corners.push_back(face[0]);
                    cur->corners.push_back(face[i + 1]);
                    cur->corners.push_back(face[i]);
                }
            }
        }
        p = line_end + 1;
    }

    if (model.materials.empty()) {
        model.materials.emplace_back();
        model.materials.back().name = "default";
    }

    for (Group& g : groups) {
        if (g.corners.empty()) continue;
        Mesh mesh;
        mesh.material = g.material;
        mesh.name = g.name;
        std::unordered_map<Key, int32_t, KeyHash> welded;
        welded.reserve(g.corners.size());
        bool all_normals = true;
        mesh.indices.reserve(g.corners.size());
        for (const Key& k : g.corners) {
            auto it = welded.find(k);
            int32_t idx;
            if (it == welded.end()) {
                idx = (int32_t)(mesh.positions.size() / 3);
                welded.emplace(k, idx);
                // malformed files can reference positions that don't exist
                // (index 0, past-the-end, or deep negatives) — zero them
                // instead of reading out of bounds
                static const Vec3 zero{};
                const Vec3& pv = (k.v >= 0 && (size_t)k.v < positions.size())
                                     ? positions[(size_t)k.v] : zero;
                mesh.positions.insert(mesh.positions.end(), {pv.x, pv.y, pv.z});
                if (k.t >= 0 && (size_t)k.t < uvs.size()) {
                    // flip V to match the engine's image-row convention
                    mesh.uvs.insert(mesh.uvs.end(), {uvs[(size_t)k.t].x, 1.0f - uvs[(size_t)k.t].y});
                } else {
                    mesh.uvs.insert(mesh.uvs.end(), {0.0f, 0.0f});
                }
                if (k.n >= 0 && (size_t)k.n < normals.size()) {
                    const Vec3& nv = normals[(size_t)k.n];
                    float len = std::sqrt(nv.x*nv.x + nv.y*nv.y + nv.z*nv.z);
                    len = len < 1e-12f ? 1.0f : len;
                    mesh.normals.insert(mesh.normals.end(), {nv.x/len, nv.y/len, nv.z/len});
                } else {
                    mesh.normals.insert(mesh.normals.end(), {0.0f, 0.0f, 0.0f});
                    all_normals = false;
                }
            } else {
                idx = it->second;
            }
            mesh.indices.push_back(idx);
        }
        if (!all_normals) compute_normals(mesh);
        compute_tangents(mesh);
        morton_sort(mesh);
        model.meshes.push_back(std::move(mesh));
    }
    return handle;
}

int tt_mesh_count(TTModel* m) { return (int)m->model.meshes.size(); }
int tt_material_count(TTModel* m) { return (int)m->model.materials.size(); }
int tt_mesh_vertex_count(TTModel* m, int i) { return (int)(m->model.meshes[(size_t)i].positions.size() / 3); }
int tt_mesh_index_count(TTModel* m, int i) { return (int)m->model.meshes[(size_t)i].indices.size(); }
int tt_mesh_material(TTModel* m, int i) { return m->model.meshes[(size_t)i].material; }

const char* tt_mesh_name(TTModel* m, int i) { return m->model.meshes[(size_t)i].name.c_str(); }

void tt_mesh_copy(TTModel* m, int i, float* pos, float* nrm, float* tan,
                  float* bit, float* uv, int32_t* idx) {
    const Mesh& mesh = m->model.meshes[(size_t)i];
    memcpy(pos, mesh.positions.data(), mesh.positions.size() * sizeof(float));
    memcpy(nrm, mesh.normals.data(), mesh.normals.size() * sizeof(float));
    memcpy(tan, mesh.tangents.data(), mesh.tangents.size() * sizeof(float));
    memcpy(bit, mesh.bitangents.data(), mesh.bitangents.size() * sizeof(float));
    memcpy(uv, mesh.uvs.data(), mesh.uvs.size() * sizeof(float));
    memcpy(idx, mesh.indices.data(), mesh.indices.size() * sizeof(int32_t));
}

void tt_material_get(TTModel* m, int i, float* base_color4, float* mr2,
                     char* name, int name_len, char* tex, int tex_len) {
    const Material& mat = m->model.materials[(size_t)i];
    memcpy(base_color4, mat.base_color, 4 * sizeof(float));
    mr2[0] = mat.metallic;
    mr2[1] = mat.roughness;
    snprintf(name, (size_t)name_len, "%s", mat.name.c_str());
    snprintf(tex, (size_t)tex_len, "%s", mat.texture.c_str());
}

void tt_free(TTModel* m) { delete m; }

}  // extern "C"
